"""The port's Stokes slice against ipde_tpu: the Stokeslet apply (plain
version against the XLA path and the Pallas kernel in interpret mode), the
host Stokes forms, FourierPlan1D and the batched 2D transforms,
HybridInterp2D and the batched radial->grid merge, the annular Stokes
operators and solve, the Stokes QFS maps, the Stokes BIE, and the whole
interior Stokes slice (StokesSolver(grid_backend="dense") +
StokesDirichletBIE) on star(128, a=0.1, f=5), M=8, both packages built from
one saved geometry.  Also the port's own MMS at nb=600, M=16 with the
asserts of tests/test_interior_stokes.py, and (marker ``gpu``, skipped with a
reason where torch sees no CUDA device) the CUDA kernel against the plain
version and the slice on the card against the slice on the CPU.

Inputs are made with numpy from seeds.  Tolerances, unless stated where
used: 1e-12 for the Stokeslet apply, u and v relative to max(1, max|u|) and
p relative to max(1, |p|) per row, as tests/test_pallas_ds.py measures the
Pallas kernel (near-coincident rows have |p| ~ 1e2); bit-equal for host
numpy forms; 1e-13 relative to the largest value for single operator
applies (the same float64 sums in another order)."""

import copy
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np, ds_round, rel as _rel
from _torch_testing import cuda_or_skip as _cuda
from _torch_testing import fuf, fvf, usol, vsol
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.ops import fourier as jfourier
from ipde_tpu.ops import interp as jinterp
from ipde_tpu.ops import pallas_ds
from ipde_tpu.ops import stokes_kernels as jsk
from ipde_tpu.ops.cx import Cx
from ipde_tpu.solvers import annular_stokes as jann
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import fourier, interp
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.solvers import annular_stokes as ann
from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
from ipde_tpu_torch.solvers.scalar import PoissonSolver
from ipde_tpu_torch.solvers.vector import StokesSolver

NB, M = 128, 8
STAR = (tt.body(NB, M, a=0.1, f=5),)


def _cloud(T=700, S=300, seed=2, near=True):
    """The clouds of tests/test_pallas_ds.py (near-coincident targets, no
    exactly coincident pair) with a second force component."""
    rng = np.random.default_rng(seed)
    sx = np.cos(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    sy = np.sin(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    r = 0.8 * np.sqrt(rng.uniform(0.01, 1, T))
    th = rng.uniform(0, 2 * np.pi, T)
    tx = r * np.cos(th)
    ty = r * np.sin(th)
    if near:
        k = min(32, T, S)
        tx[:k] = sx[:k] + 10.0 ** rng.uniform(-4, -2, k)
        ty[:k] = sy[:k] + 10.0 ** rng.uniform(-4, -2, k)
    qx = rng.standard_normal(S) / S
    qy = np.random.default_rng(seed + 1).standard_normal(S) / S
    return tuple(ds_round(a) for a in (sx, sy, qx, qy, tx, ty))


def _uvp_err(got, want):
    """Max error of (u, v, p): u, v relative to max(1, max|u|, max|v|), p
    relative to max(1, |p|) per row."""
    (u, v, p), (uu, vv, pp) = map(_np, got), map(np.asarray, want)
    scale = max(1.0, np.abs(uu).max(), np.abs(vv).max())
    pscale = np.maximum(1.0, np.abs(pp))
    return max(np.abs(u - uu).max() / scale, np.abs(v - vv).max() / scale,
               (np.abs(p - pp) / pscale).max())


# ---------------------------------------------------------------------------
# the Stokeslet apply and the host forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,near", [(2, True), (4, False), (7, True)])
def test_apply_matches_xla_path(seed, near):
    args = _cloud(seed=seed, near=near)
    got = sk.stokes_slp_apply(*map(torch.as_tensor, args))
    want = [np.asarray(a) for a in jsk.stokes_slp_apply(*map(jnp.asarray,
                                                             args))]
    assert _uvp_err(got, want) < 1e-12


def test_apply_matches_pallas_interpret():
    # the cloud of tests/test_pallas_ds.py::test_stokes_slp_matches_f64; on
    # other seeds the double-single kernel's own pressure error reaches
    # 1.3e-11 of float64 (measured), so the next test holds the port to
    # numpy float64 there
    args = _cloud(seed=2)
    got = sk.stokes_slp_apply(*map(torch.as_tensor, args))
    want = [np.asarray(a) for a in
            pallas_ds.stokes_slp_apply(*args, interpret=True)]
    assert _uvp_err(got, want) < 1e-12


@pytest.mark.parametrize("seed", [2, 3, 5, 6])
def test_apply_matches_numpy_f64(seed):
    sx, sy, qx, qy, tx, ty = args = _cloud(seed=seed)
    dx = tx[:, None] - sx
    dy = ty[:, None] - sy
    r2 = dx * dx + dy * dy
    ilr = -0.5 * np.log(r2)
    ir2 = 1.0 / r2
    uu = ((ilr + dx * dx * ir2) @ qx + (dx * dy * ir2) @ qy) / (4 * np.pi)
    vv = ((dx * dy * ir2) @ qx + (ilr + dy * dy * ir2) @ qy) / (4 * np.pi)
    pp = ((dx * ir2) @ qx + (dy * ir2) @ qy) / (2 * np.pi)
    got = sk.stokes_slp_apply(*map(torch.as_tensor, args))
    # one float64 sum in another order: measured <= 9e-16
    assert _uvp_err(got, (uu, vv, pp)) < 1e-14


def test_apply_clamps_coincident_pairs_and_checks():
    sx, sy, qx, qy, tx, ty = map(torch.as_tensor, _cloud(T=40, S=30))
    # a target ON a source: r^2 = 0 is clamped at 1e-30 in every term, as
    # in the TPU kernel; that pair adds -log(1e-30)/2 (fx, fy) / (4 pi) and
    # no pressure
    tx[0], ty[0] = sx[3], sy[3]
    before = sk.stokes_slp_apply.launches
    u, v, p = sk.stokes_slp_apply(sx, sy, qx, qy, tx, ty)
    assert sk.stokes_slp_apply.launches == before     # the CPU route
    assert all(torch.isfinite(a).all() for a in (u, v, p))
    keep = torch.arange(30) != 3
    ru, rv, rp = sk.stokes_slp_apply(sx[keep], sy[keep], qx[keep], qy[keep],
                                     tx[:1], ty[:1])
    c = -0.5 * np.log(1e-30) / (4 * np.pi)
    assert abs(float(u[0] - ru[0]) - c * float(qx[3])) < 1e-12
    assert abs(float(v[0] - rv[0]) - c * float(qy[3])) < 1e-12
    assert abs(float(p[0] - rp[0])) < 1e-12
    for bad in ((sx.float(), sy, qx, qy, tx, ty),
                (sx, sy, qx[:-1], qy, tx, ty),
                (sx, sy, qx, qy, tx[::2], ty[::2]),
                (sx, sy, qx, qy, tx[:, None], ty[:, None])):
        with pytest.raises((TypeError, ValueError)):
            sk.stokes_slp_apply(*bad)


def test_plain_apply_unchanged_under_spatial_order():
    from ipde_tpu_torch.ops.kernels import spatial_order
    sx, sy, fx, fy, tx, ty = map(torch.as_tensor, _cloud(T=900, S=200, seed=8))
    perm = spatial_order(tx, ty)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    want = sk.stokes_slp_apply(sx, sy, fx, fy, tx, ty)
    got = sk.stokes_slp_apply(sx, sy, fx, fy, tx[perm].contiguous(),
                              ty[perm].contiguous())
    for g, w in zip(got, want):
        assert float((g[inv] - w).abs().max()) <= 1e-14 * float(w.abs().max())


def test_host_forms_bit_equal():
    jc, tc = jstar(96, a=0.15, f=5), star(96, a=0.15, f=5)
    jsrc, tsrc = jc.complex_offset(0.05), tc.complex_offset(0.05)
    tx = 0.6 * np.cos(np.linspace(0, 6, 50))
    ty = 0.5 * np.sin(np.linspace(0, 6, 50))
    for name in ("stokes_slp_naive", "stokes_slp_pressure_naive",
                 "stokes_dlp_naive", "stokes_dlp_pressure_naive"):
        assert np.array_equal(getattr(sk, name)(tsrc, tx, ty),
                              getattr(jsk, name)(jsrc, tx, ty)), name
    for name in ("stokes_slp_self", "stokes_dlp_self"):
        assert np.array_equal(getattr(sk, name)(tc),
                              getattr(jsk, name)(jc)), name
    assert np.array_equal(sk.stokes_pressure_fix(tsrc, tc.normal_x,
                                                 tc.normal_y),
                          jsk.stokes_pressure_fix(jsrc, jc.normal_x,
                                                  jc.normal_y))


# ---------------------------------------------------------------------------
# Fourier plans and interpolation
# ---------------------------------------------------------------------------

def test_fourier_plan_1d_and_stacks():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 96))
    jp, tp = jfourier.FourierPlan1D(96), fourier.FourierPlan1D(96,
                                                               device="cpu")
    assert _rel(tp.tderiv(torch.as_tensor(x)), jp.tderiv(jnp.asarray(x))) \
        < 1e-13
    fs = rng.standard_normal((3, 64, 48))
    j2, t2 = jfourier.FourierPlan2D(64, 48), fourier.FourierPlan2D(64, 48)
    tc = t2.fft2_stack([torch.as_tensor(f) for f in fs])
    jcs = j2.fft2_stack([jnp.asarray(f) for f in fs])
    for i, jc in enumerate(jcs):
        assert _rel(tc[i].real, jc.re) < 1e-13
        assert _rel(tc[i].imag, jc.im) < 1e-13
    back = t2.ifft2_real_stack(tc)
    for i, jb in enumerate(j2.ifft2_real_stack(jcs)):
        assert _rel(back[i], jb) < 1e-13
        assert _rel(back[i], fs[i]) < 1e-13


def _hybrid_pair(nx=32, ny=400, T=40000, seed=12):
    rng = np.random.default_rng(seed)
    tx = rng.uniform(0, np.pi, T)
    ty = rng.uniform(0, 2 * np.pi, T)
    off = np.pi / nx
    return (tx, ty, interp.HybridInterp2D(nx, ny, tx, ty, x_offset=off,
                                          device="cpu"),
            jinterp.HybridInterp2D(nx, ny, tx, ty, x_offset=off))


def test_hybrid_interp_matches_reference():
    tx, ty, tp, jp = _hybrid_pair()
    rng = np.random.default_rng(13)
    c = (rng.standard_normal((3, 32, 400))
         + 1j * rng.standard_normal((3, 32, 400)))
    jc = Cx(jnp.asarray(c.real), jnp.asarray(c.imag))
    tc = torch.as_tensor(c)
    assert _rel(tp.from_modes(tc), jp.from_modes(jc)) < 1e-13
    assert _rel(tp.from_modes(tc[1]),
                jp.from_modes(Cx(jc.re[1], jc.im[1]))) < 1e-13
    f = rng.standard_normal((2, 32, 400))
    assert _rel(tp(torch.as_tensor(f)), jp(jnp.asarray(f))) < 1e-13
    # and the routing sends such a plan (T > 4 * 8192, nx <= 64) there
    assert isinstance(interp.make_interpolator(32, 400, tx, ty,
                                               device="cpu"),
                      interp.HybridInterp2D)


# ---------------------------------------------------------------------------
# the slice on one saved geometry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """star(128, a=0.1, f=5), M=8 solved by ipde_tpu (dense grid backend),
    and the port's solver and BIE built from the saved geometry."""
    h = tt.one_body_h(STAR[0])
    jc, tc = tt.paired_collections(STAR, h)
    ref = tt.reference_solve(STAR, h, "stokes", (fuf, fvf), (usol, vsol))
    jfu, jfv = ref["jf"]
    return dict(jc=jc, js=ref["js"], jb=ref["jb"], jraw=ref["jraw"],
                jst=ref["jst"], juvp=ref["jue"], tc=tc,
                ts=tt.port_solver(STAR, h, "stokes"),
                tb=tt.port_bie(STAR, h, "stokes"),
                tfu=EmbeddedFunction.load(jfu.save(), "cpu"),
                tfv=EmbeddedFunction.load(jfv.save(), "cpu"),
                tbu=BoundaryFunction.from_function(tc, usol),
                tbv=BoundaryFunction.from_function(tc, vsol))


def test_annular_stokes_matvec_and_precond(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    jops = jh.annular_solver.make_ops(jh.metric)
    tops = th.annular_solver.make_ops(th.metric)
    Mr, n = th.annular_solver.M, th.annular_solver.n
    # the preconditioner blocks come from the same host numpy inverses
    Kinv = _np(tops.Kinv)
    assert np.array_equal(Kinv.real, _np(jops.Kinv_re))
    assert np.array_equal(Kinv.imag, _np(jops.Kinv_im))
    rng = np.random.default_rng(21)
    for _ in range(2):
        x = rng.standard_normal((3 * Mr - 1) * n)
        assert _rel(ann._matvec(tops, torch.as_tensor(x), Mr, n),
                    jann._matvec(jops, jnp.asarray(x), Mr, n)) < 1e-13
        assert _rel(ann._precond(tops, torch.as_tensor(x), Mr, n),
                    jann._precond(jops, jnp.asarray(x), Mr, n)) < 1e-13


def test_annular_stokes_solve(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    rng = np.random.default_rng(22)
    fr, ft = rng.standard_normal((2, M, NB))
    z = np.zeros(NB)
    (jur, jut, jp), jst = jh.annular_solver.solve_with_stats(
        jh.metric, jnp.asarray(fr), jnp.asarray(ft), z, z, z, z, **SOLVE)
    zt = torch.zeros(NB, dtype=torch.float64)
    (tur, tut, tp), tst = th.annular_solver.solve_with_stats(
        th.metric, torch.as_tensor(fr), torch.as_tensor(ft), zt, zt, zt, zt,
        **SOLVE)
    assert tst["residual"] <= SOLVE["tol"]
    assert abs(tst["iterations"] - int(jst["iterations"])) <= 1
    # both stop at a 1e-12 relative residual: the solutions agree to that,
    # times the preconditioned operator's small condition number
    assert _rel(tur, jur) < 1e-11
    assert _rel(tut, jut) < 1e-11
    dp, jpn = _np(tp) - np.asarray(jp), np.asarray(jp)
    assert np.abs(dp - dp.mean()).max() / np.abs(jpn).max() < 1e-11
    with pytest.raises(RuntimeError, match="did not converge"):
        th.annular_solver.solve_with_stats(
            th.metric, torch.as_tensor(fr), torch.as_tensor(ft), zt, zt, zt,
            zt, tol=1e-12, maxiter=2, restart=2)


def test_stokes_qfs_maps(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    # one host LAPACK composition from identical inputs
    for jq, tq in ((jh.qfs_g, th.qfs_g), (jh.qfs_r, th.qfs_r),
                   (problem["jb"].qfs_list[0], problem["tb"].qfs_list[0])):
        assert len(jq.mats) == len(tq.mats)
        for jm, tm in zip(jq.mats, tq.mats):
            assert np.array_equal(_np(jm), _np(tm))
    rng = np.random.default_rng(23)
    taus, taud = rng.standard_normal((2, 2 * NB))
    assert _rel(th.qfs_g([torch.as_tensor(taus), torch.as_tensor(taud)]),
                jh.qfs_g([jnp.asarray(taus), jnp.asarray(taud)])) < 1e-13


def test_stratified_apply_three_outputs(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    assert np.array_equal(jh.radial_plan.strides, th.radial_plan.strides)
    rng = np.random.default_rng(24)
    sig = rng.standard_normal(2 * th.radial_source.N)
    sN = th.radial_source.N
    jsig, tsig = jnp.asarray(sig), torch.as_tensor(sig)
    want = jh.radial_plan.apply(
        lambda sx, sy, ws, f, tx, ty: jsk.stokes_slp_apply(
            sx, sy, jsig[:sN][::f] * ws, jsig[sN:][::f] * ws, tx, ty),
        n_out=3)
    got = th.radial_plan.apply(
        lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
            sx, sy, tsig[:sN][::f] * ws, tsig[sN:][::f] * ws, tx, ty),
        n_out=3)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-13


@pytest.mark.parametrize("hybrid", [False, True])
def test_radial_to_grid_many(problem, hybrid):
    jc, tc = problem["jc"], problem["tc"]
    if hybrid:
        # the same targets through HybridInterp2D on both sides (the class
        # the bench geometry's radial plan routes to), on copies of the
        # shared collections
        e, reg = tc.ebdys[0], tc.regs[0]
        args = (2 * M, NB, e.nufft_theta(reg.ia_r), reg.ia_t)
        off = np.pi / (2 * M)
        jc, tc = copy.copy(jc), copy.copy(tc)
        jc.radial_to_grid_plans = [jinterp.HybridInterp2D(*args,
                                                          x_offset=off)]
        tc.radial_to_grid_plans = [interp.HybridInterp2D(
            *args, x_offset=off, device="cpu")]
    rng = np.random.default_rng(25)
    rads = rng.standard_normal((3, M, NB))
    grids = rng.standard_normal((3,) + tc.grid.shape)
    want = jc.interpolate_radial_to_grid_many(
        [[jnp.asarray(r)] for r in rads], [jnp.asarray(g) for g in grids])
    got = tc.interpolate_radial_to_grid_many(
        [[torch.as_tensor(r)] for r in rads],
        [torch.as_tensor(g) for g in grids])
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-13


def test_stokes_bie(problem):
    jb, tb = problem["jb"], problem["tb"]
    assert np.array_equal(_np(jb.Ainv), _np(tb.Ainv))
    # the BIE correction of one and the same inhomogeneous solution
    raw = [EmbeddedFunction.load(f.save(), "cpu") for f in problem["jraw"]]
    got = tb.apply_bc(*raw, problem["tbu"], problem["tbv"])
    # the pressure kernel dx / r^2 is one order more singular than the
    # velocity's log and the QFS sources sit ~1.5 h from the grid, so its
    # sums cancel more: 1e-12 (measured 2.0e-13); velocity 1e-13 (2.3e-14)
    for g, w, tol in zip(got, problem["juvp"], (1e-13, 1e-13, 1e-12)):
        assert _rel(g.grid, w.grid) < tol
        assert _rel(g.radials[0], w.radials[0]) < tol


def _pressure_gap(p, ref, phys):
    """max |p - ref - c| over physical points and radial nodes, with c the
    mean of p - ref over the physical grid points (the pressure is defined
    up to a constant)."""
    dg = _np(p.grid) - _np(ref.grid)
    c = dg[phys].mean()
    return max(np.abs(dg - c)[phys].max(),
               np.abs(_np(p.radials[0]) - _np(ref.radials[0]) - c).max())


def test_whole_slice_matches_reference(problem):
    ts, tb = problem["ts"], problem["tb"]
    assert ts.grid_backend == "dense"
    raw, st = ts.solve_with_stats(problem["tfu"], problem["tfv"], **SOLVE)
    u, v, p = tb.apply_bc(*raw, problem["tbu"], problem["tbv"])
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert abs(st["annular_iterations"][0]
               - int(problem["jst"]["annular_iterations"][0])) <= 1
    # GMRES stops at 1e-12 and the sums are ordered differently: the two
    # packages agree to 1e-10 absolute on an O(1) solution
    ju, jv, jp = problem["juvp"]
    phys = problem["tc"].phys
    for g, w in ((u, ju), (v, jv)):
        assert np.abs(_np(g.grid) - _np(w.grid))[phys].max() <= 1e-10
        assert np.abs(_np(g.radials[0]) - _np(w.radials[0])).max() <= 1e-10
    assert _pressure_gap(p, jp, phys) <= 1e-10
    # the tractions of the corrected solution on the boundary
    for (gx, gy), (wx, wy) in zip(
            ts.get_boundary_tractions(u, v, p),
            problem["js"].get_boundary_tractions(ju, jv, jp)):
        # p enters the traction: compare with the constants matched
        c = (_np(p.grid) - _np(jp.grid))[phys].mean()
        nx, ny = problem["tc"].ebdys[0].bdy.normal_x, \
            problem["tc"].ebdys[0].bdy.normal_y
        assert np.abs(_np(gx) - np.asarray(wx) + c * nx).max() <= 1e-9
        assert np.abs(_np(gy) - np.asarray(wy) + c * ny).max() <= 1e-9


def test_unported_options_raise(problem):
    tc = problem["tc"]
    # the grid backend defaults to "fft", as in ipde_tpu; an unknown one
    # raises ValueError
    assert inspect.signature(StokesSolver).parameters["grid_backend"].default \
        == "fft"
    with pytest.raises(ValueError, match="spectral"):
        StokesSolver(tc, grid_backend="spectral")
    # an unknown solver type raises ValueError, in both solvers
    for make in (StokesSolver, PoissonSolver):
        with pytest.raises(ValueError, match="sixth"):
            make(tc, grid_backend="dense", solver_type="sixth")
    # several boundaries and an inclusion are ported: such collections now
    # build a solver (tests/test_torch_multi_stokes.py solves them), and so
    # does solver_type "fourth" (tests/test_torch_fourth.py solves it); a
    # copy of the boundary, which the new collection registers on its grid
    e = copy.deepcopy(tc.ebdys[0])
    inner = star(64, x=0.05, y=0.0, r=0.3, a=0.05, f=3)
    other = EmbeddedBoundaryCollection(
        [e, EmbeddedBoundary(inner, False, 4, e.h)], device="cpu")
    other.generate_grid(e.h)
    solver = StokesSolver(other, grid_backend="dense", solver_type="fourth")
    assert solver.solver_type == "fourth"
    assert [h.interior for h in solver.helpers] == [True, False]
    assert all(h.qfs_r.u2s_mat is not None for h in solver.helpers)
    assert PoissonSolver(other, grid_backend="dense",
                         solver_type="fourth").solver_type == "fourth"


# the MMS of tests/test_interior_stokes.py
A_, B_ = 2.0, 1.0
PA, PB = 1.0, 2.0
sin, cos, exp = np.sin, np.cos, np.exp


def u_f(x, y):
    return exp(sin(A_ * x)) * cos(B_ * y)


def v_f(x, y):
    return -A_ / B_ * cos(A_ * x) * exp(sin(A_ * x)) * sin(B_ * y)


def p_f(x, y):
    return cos(PA * x) + exp(sin(PB * y))


def fu_f(x, y):
    return ((A_**2 * (sin(A_ * x) - cos(A_ * x) ** 2) + B_**2) * u_f(x, y)
            - PA * sin(PA * x))


def fv_f(x, y):
    return (-A_ * B_ * cos(A_ * x) * exp(sin(A_ * x)) * sin(B_ * y)
            * (1 + (A_ / B_) ** 2 * sin(A_ * x) * (3 + sin(A_ * x)))
            + PB * cos(PB * y) * exp(sin(PB * y)))


def test_port_mms_nb600():
    """tests/test_interior_stokes.py's case (star(600, a=0.15, f=5), M=16)
    on the port alone, with its asserts, at tol=1e-12 (the port's GMRES
    checks its true residual, whose float64 floor is above 1e-13 here).
    Dense grid backend: on the CPU it is the cheaper one at this size, and
    tests/test_torch_grid_eval_slices.py holds the fft slice."""
    nb, Mr = 600, 16
    bdy = star(nb, a=0.15, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / Mr)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, Mr, bh, qfs_tolerance=1e-14)],
        device="cpu")
    ebdyc.generate_grid(bh)
    solver = StokesSolver(ebdyc, grid_backend="dense")
    bie = StokesDirichletBIE(solver)
    fu = EmbeddedFunction.from_function(ebdyc, fu_f)
    fv = EmbeddedFunction.from_function(ebdyc, fv_f)
    u, v, p = solver(fu, fv, tol=1e-12)
    u, v, p = bie.apply_bc(u, v, p, BoundaryFunction.from_function(ebdyc, u_f),
                           BoundaryFunction.from_function(ebdyc, v_f))
    phys = ebdyc.phys
    e = ebdyc.ebdys[0]

    def err(g, f):
        return max(np.abs(_np(g.grid) - f(ebdyc.grid.xg,
                                          ebdyc.grid.yg))[phys].max(),
                   np.abs(_np(g.radials[0]) - f(e.radial_x, e.radial_y)).max())

    pa = EmbeddedFunction.from_function(ebdyc, p_f)
    assert err(u, u_f) < 2e-9      # ipde_tpu measured 5.84e-10
    assert err(v, v_f) < 2e-9      # ipde_tpu measured 6.25e-10
    assert _pressure_gap(p, pa, phys) < 8e-8   # ipde_tpu measured 3.59e-8


# ---------------------------------------------------------------------------
# on the card (marker gpu)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("T,S,seed", [(700, 300, 2), (70001, 3001, 4),
                                      (1, 1, 5), (257, 255, 6)])
def test_cuda_kernel_matches_plain(T, S, seed):
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev)
            for a in _cloud(T=T, S=S, seed=seed)]
    before = sk.stokes_slp_apply.launches
    got = sk.stokes_slp_apply(*args)
    torch.cuda.synchronize()
    assert sk.stokes_slp_apply.launches == before + 1
    want = [a.cpu().numpy() for a in sk.stokes_slp_apply_plain(*args)]
    assert _uvp_err(got, want) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,seed", [(3600, 1800, 2), (13200, 3600, 3),
                                      (67584, 300, 4), (67585, 300, 4),
                                      (8193, 1023, 5), (33, 31, 6)])
def test_cuda_kernel_split_and_ragged_shapes(T, S, seed):
    """Launches on either side of the split threshold (sources split across
    blocks below ~67,584 targets) and with T and S that are multiples of no
    tile: within 1e-12 of the plain version, and two runs bit-equal."""
    from ipde_tpu_torch.ops.kernels import split_count
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev)
            for a in _cloud(T=T, S=S, seed=seed)]
    if S >= 64:
        assert (split_count("stokes_slp", T, S) > 1) == (T <= 67584)
    got = sk.stokes_slp_apply(*args)
    again = sk.stokes_slp_apply(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = [a.cpu().numpy() for a in sk.stokes_slp_apply_plain(*args)]
    assert _uvp_err(got, want) <= 1e-12


@pytest.mark.gpu
def test_cuda_device_math_matches_library():
    """csrc/fp64_math.cuh on the card: log to 4e-16 max(1, |log|), the
    reciprocal, the reciprocal square root and exp(-a) to a few ulp; NaN
    and infinity come through the log as the library gives them."""
    dev = _cuda()
    rng = np.random.default_rng(13)
    a = np.concatenate([10.0 ** rng.uniform(-30, 3, 900_000),
                        1.0 + rng.uniform(-1e-8, 1e-8, 100_000), [1.0]])
    lg, rc, rs, ex = (o.cpu().numpy() for o in
                      sk.fp64_math_probe(torch.as_tensor(a, device=dev)))
    want = np.log(a.astype(np.longdouble))
    err = np.abs(lg.astype(np.longdouble) - want) / np.maximum(1, np.abs(want))
    assert float(err.max()) <= 4e-16
    assert (np.abs(rc * a - 1.0)).max() <= 4 * 2.0 ** -53
    assert (np.abs(rs * rs * a - 1.0)).max() <= 16 * 2.0 ** -53
    want = np.exp(-np.minimum(a, 700.0).astype(np.longdouble))
    assert float((np.abs(ex - want) / want).max()) <= 4e-16
    odd = torch.tensor([float("nan"), float("inf"), 0.0, -1.0, 5e-324],
                       dtype=torch.float64, device=dev)
    lg = sk.fp64_math_probe(odd)[0].cpu()
    assert torch.equal(torch.isnan(lg), torch.isnan(odd.cpu().log()))
    assert torch.equal(lg[[1, 2, 4]], odd.cpu().log()[[1, 2, 4]])


@pytest.mark.gpu
def test_cuda_kernel_carries_nan():
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev)
            for a in _cloud(T=600, S=300, seed=2)]
    args[4][17] = float("nan")
    u, v, p = sk.stokes_slp_apply(*args)
    for o in (u, v, p):
        bad = torch.isnan(o).nonzero().flatten().tolist()
        assert bad == [17]


@pytest.mark.gpu
def test_slice_on_cuda_matches_cpu(monkeypatch):
    """star(128, a=0.1, f=5), M=8 solved by the port on the card and on the
    CPU: the kernel's and the plain version's sums differ in order only, and
    GMRES stops at 1e-12."""
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    out = {}
    for dev in ("cpu", _cuda()):
        bdy = star(NB, a=0.1, f=5)
        bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
        ebdyc = EmbeddedBoundaryCollection(
            [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
            device=dev)
        ebdyc.generate_grid(bh)
        solver = StokesSolver(ebdyc)
        bie = StokesDirichletBIE(solver)
        before = sk.stokes_slp_apply.launches
        uvp = bie.apply_bc(
            *solver(EmbeddedFunction.from_function(ebdyc, fuf),
                    EmbeddedFunction.from_function(ebdyc, fvf), **SOLVE),
            BoundaryFunction.from_function(ebdyc, usol),
            BoundaryFunction.from_function(ebdyc, vsol))
        out[str(dev)] = (uvp, sk.stokes_slp_apply.launches - before,
                         ebdyc.phys)
    (cpu, nc, phys), (gpu, ng, _) = out["cpu"], out["cuda:0"]
    assert nc == 0 and ng > 0
    for c, g in zip(cpu[:2], gpu[:2]):
        assert np.abs(_np(c.grid) - _np(g.grid)).max() <= 1e-10
        assert np.abs(_np(c.radials[0]) - _np(g.radials[0])).max() <= 1e-10
    assert _pressure_gap(gpu[2], cpu[2], phys) <= 1e-10
