"""The port's modified Helmholtz (Yukawa) slice and the Laplace gradient
apply against ipde_tpu: the K0 split and its Chebyshev fit, the Yukawa and
gradient applies (plain versions against numpy/scipy float64 and the XLA
path), the annular Yukawa operators, the Yukawa QFS maps, the Dirichlet and
Neumann BIEs, and the whole interior slices ModifiedHelmholtzSolver
(grid_backend="dense") + DirichletBIE (k = 2) and + NeumannBIE (k = 20,
where the self forms oversample the curve 9-fold), and PoissonSolver +
NeumannBIE, each on star(128, a=0.1, f=3), M=8, both packages built from one
saved geometry.  Also (marker ``slow``) the port's own MMS runs with the
asserts of tests/test_interior_mh.py and tests/test_neumann.py, and
(marker ``gpu``, skipped with a reason where torch sees no CUDA device) the
CUDA kernels against their plain versions and the slice on the card against
the CPU.

Inputs are made with numpy from seeds.  Tolerances, unless stated where
used: 1e-12 absolute for the applies (values ~1e-2, as
tests/test_pallas_ds.py holds the Pallas kernel); bit-equal for host numpy
maps; 1e-13 relative to the largest value for single operator applies (the
same float64 sums in another order); 1e-10 absolute for whole slices (GMRES
stops at 1e-12)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import k0 as scipy_k0

import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np, cloud, rel as _rel
from _torch_testing import cuda_or_skip as _cuda
from _torch_testing import mgrad as grad_sol, msol as sol
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.geometry.annular import AnnularGeometry as JAG
from ipde_tpu.ops import kernels as jkernels
from ipde_tpu.ops import pallas_ds
from ipde_tpu.solvers import annular_scalar as jann
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.annular import AnnularGeometry
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels
from ipde_tpu_torch.qfs import qfs as tqfs
from ipde_tpu_torch.solvers import annular_scalar as ann
from ipde_tpu_torch.solvers.bie import DirichletBIE, NeumannBIE
from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver

NB, M = 128, 8
ENTRY = (tt.body(NB, M, a=0.1, f=3),)


# the manufactured solution of tests/test_interior_mh.py and test_neumann.py
# is tt.msol; its Laplacian here as those files write it
def lap_sol(x, y):
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    u2 = 0.3 * np.cos(3 * x) * np.cos(y)
    return u1xx - 4 * u1 - 10 * u2


@functools.lru_cache(maxsize=None)
def _forcing(k):
    """k^2 sol - lap sol (k None: lap sol, the Poisson forcing), one
    function object per k."""
    if k is None:
        return lap_sol
    return lambda x, y: k ** 2 * sol(x, y) - lap_sol(x, y)


def _mms_err(ebdyc, ue):
    return tt.mms_err(ebdyc, ue, sol)


# ---------------------------------------------------------------------------
# K0 and the applies
# ---------------------------------------------------------------------------

def test_k0_split_matches_scipy():
    # tests/test_pallas_ds.py::test_k0_ds_accuracy's points and bound
    z = np.concatenate([10.0 ** np.linspace(-8, 0.3, 1001),
                        np.linspace(0.5, 40.0, 2001)])
    got = _np(kernels.k0_split(torch.as_tensor(z), torch.as_tensor(z * z / 4)))
    err = np.abs(got - np.where(z > 36.0, 0.0, scipy_k0(z)))
    bound = 2e-14 + np.abs(np.log(z * z / 4.0)) * 2.0 ** -47
    assert (err / bound).max() < 1.0, (err / bound).max()


def _port_fit(z):
    """f(z) = K0(z) e^z sqrt(z) by the port's piecewise fits."""
    rows = kernels.k0_cheb_coeffs()
    br = kernels.K0_CHEB_BREAKS
    i = np.clip(np.searchsorted(br, z, side="left") - 1, 0, len(rows) - 1)
    x = rows[i, 0] / z + rows[i, 1]
    f = np.zeros_like(z)
    for j in range(kernels.K0_CHEB_DEG - 1, -1, -1):
        f = f * x + rows[i, 2 + j]
    return f


def test_k0_cheb_coeffs_match_pallas_fit():
    # the port fits three sub-intervals where the Pallas kernel fits one:
    # the two are held together as functions, on the Pallas kernel's range
    coeffs, lo, hi, ulo, uhi = pallas_ds._k0_cheb_ds()
    want_c = np.array([h + l for h, l in coeffs])   # the ds pairs, summed
    got = kernels.k0_cheb_coeffs()
    br = kernels.K0_CHEB_BREAKS
    assert (lo, hi) == (kernels.K0_CHEB_LO, kernels.K0_CHEB_HI) \
        == (br[0], br[-1])
    assert got.shape == (len(br) - 1, 2 + kernels.K0_CHEB_DEG)
    z = np.concatenate([np.linspace(lo, hi, 4001), np.asarray(br)])
    x = (2.0 / z - (uhi + ulo)) / (uhi - ulo)
    want = np.polynomial.chebyshev.chebval(x, want_c)
    # a ds pair holds ~48 bits: 2^-48 ~ 3.6e-15 relative
    assert (np.abs(_port_fit(z) - want) / want).max() < 1e-14


@pytest.mark.parametrize("which", ["series", "fits", "layout"])
def test_k0_fit_residuals_and_layout(which):
    """The host fits the CUDA kernel is handed: each stays within 3e-15 of
    scipy (relative; the series against I0 and K0 themselves), and k0_fit
    packs them in the order of the kernel's K0Fit."""
    from scipy.special import i0 as scipy_i0
    from scipy.special import k0e as scipy_k0e
    if which == "series":
        i0_c, reg_c = kernels.k0_series_coeffs()
        assert i0_c.shape == reg_c.shape == (kernels.K0_SERIES_DEG,)
        z = np.linspace(1e-6, 2.0, 3001)
        q = z * z / 4
        hi0 = np.polyval(i0_c[::-1], q)
        assert (np.abs(hi0 - scipy_i0(z)) / scipy_i0(z)).max() < 3e-15
        k0 = np.polyval(reg_c[::-1], q) - (0.5 * np.log(q) + 0.5772156649015329) * hi0
        # R - (...) I0 cancels ~12-fold at z = 2: absolute, as the series is used
        assert np.abs(k0 - scipy_k0(z)).max() < 2e-14
    elif which == "fits":
        z = np.linspace(2.0, 36.0, 20001)
        f = scipy_k0e(z) * np.sqrt(z)
        assert (np.abs(_port_fit(z) - f) / f).max() < 3e-15
    else:
        fit = kernels.k0_fit()
        n_int = len(kernels.K0_CHEB_BREAKS) - 1
        assert fit.shape == (n_int + 1 + 2 * kernels.K0_SERIES_DEG
                             + n_int * (2 + kernels.K0_CHEB_DEG),)
        assert np.array_equal(fit[:n_int + 1],
                              np.square(kernels.K0_CHEB_BREAKS) / 4)
        assert np.array_equal(fit[n_int + 1:n_int + 1 + 2 * kernels.K0_SERIES_DEG],
                              kernels.k0_series_coeffs().ravel())
        assert np.array_equal(fit[-n_int * (2 + kernels.K0_CHEB_DEG):],
                              kernels.k0_cheb_coeffs().ravel())


def test_k0_split_picks_branch_from_q():
    # at the thresholds themselves, and one ulp to either side
    br = np.asarray(kernels.K0_CHEB_BREAKS)
    z = np.concatenate([br, np.nextafter(br, 0), np.nextafter(br, 100)])
    got = _np(kernels.k0_split(torch.as_tensor(z), torch.as_tensor(z * z / 4)))
    want = np.where(z * z / 4 > br[-1] ** 2 / 4, 0.0, scipy_k0(z))
    assert np.abs(got - want).max() < 2e-14


@pytest.mark.parametrize("T,cell", [(1, None), (257, None), (5000, None),
                                    (4096, 0.125)])
def test_spatial_order_is_a_permutation(T, cell):
    rng = np.random.default_rng(T)
    if cell is None:
        tx, ty = rng.uniform(-1, 2, (2, T))
    else:       # a 64 x 64 box grid of that spacing, row-major
        tx, ty = (a.ravel() * cell for a in np.meshgrid(
            np.arange(64), np.arange(64), indexing="ij"))
    perm = _np(kernels.spatial_order(torch.as_tensor(tx), torch.as_tensor(ty),
                                     cell))
    assert perm.dtype == np.int64
    assert np.array_equal(np.sort(perm), np.arange(T))
    if cell is not None:
        # a warp's 32 targets are an 8 x 4 patch, a block's 256 are 16 x 16
        for n, (ex, ey) in ((32, (7, 3)), (256, (15, 15))):
            px = tx[perm].reshape(-1, n)
            py = ty[perm].reshape(-1, n)
            assert np.allclose(np.ptp(px, axis=1), ex * cell)
            assert np.allclose(np.ptp(py, axis=1), ey * cell)
    assert kernels.spatial_order(torch.empty(0, dtype=torch.float64),
                                 torch.empty(0, dtype=torch.float64)).shape == (0,)


@pytest.mark.parametrize("k", [2.0, 100.0])
def test_plain_apply_unchanged_under_spatial_order(k):
    sx, sy, q, tx, ty = map(torch.as_tensor, cloud(T=900, S=200, seed=8))
    perm = kernels.spatial_order(tx, ty)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    want = kernels.mh_slp_apply(sx, sy, q, tx, ty, k)
    got = kernels.mh_slp_apply(sx, sy, q, tx[perm].contiguous(),
                               ty[perm].contiguous(), k)[inv]
    assert float((got - want).abs().max()) <= 1e-15 * float(want.abs().max())


@pytest.mark.parametrize("k", [1.0, 20.0])
def test_mh_plain_matches_scipy(k):
    sx, sy, q, tx, ty = cloud(seed=5)
    got = _np(kernels.mh_slp_apply(*map(torch.as_tensor, (sx, sy, q, tx, ty)),
                                   k))
    r = np.sqrt((tx[:, None] - sx) ** 2 + (ty[:, None] - sy) ** 2)
    want = (scipy_k0(k * r) @ q) / (2 * np.pi)
    assert np.abs(got - want).max() < 1e-12


@pytest.mark.parametrize("k,seed,near", [(1.0, 5, True), (20.0, 6, False),
                                         (100.0, 7, True)])
def test_mh_plain_matches_xla_path(k, seed, near):
    args = cloud(seed=seed, near=near)
    want = np.asarray(jkernels.mh_slp_apply(*map(jnp.asarray, args), k))
    got = _np(kernels.mh_slp_apply(*map(torch.as_tensor, args), k))
    assert np.abs(got - want).max() < 1e-12


def test_grad_plain_matches_xla_path_and_numpy():
    sx, sy, q, tx, ty = cloud(seed=1)
    gx, gy = map(_np, kernels.laplace_slp_grad_apply(
        *map(torch.as_tensor, (sx, sy, q, tx, ty))))
    dx = tx[:, None] - sx
    dy = ty[:, None] - sy
    ir2 = 1.0 / (dx * dx + dy * dy)
    wx = (-dx * ir2) @ q / (2 * np.pi)
    wy = (-dy * ir2) @ q / (2 * np.pi)
    jx, jy = map(np.asarray, jkernels.laplace_slp_grad_apply(
        *map(jnp.asarray, (sx, sy, q, tx, ty))))
    # near-coincident rows have |grad| ~ 1e7: relative to the row scale
    scale = np.maximum(1.0, np.abs(wx) + np.abs(wy))
    for got, want in ((gx, wx), (gy, wy), (gx, jx), (gy, jy)):
        assert (np.abs(got - want) / scale).max() < 1e-12


def test_wrappers_check_and_take_the_cpu_route():
    sx, sy, q, tx, ty = (torch.as_tensor(a) for a in cloud(T=64, S=32, seed=5))
    before = (kernels.mh_slp_apply.launches,
              kernels.laplace_slp_grad_apply.launches)
    out = kernels.mh_slp_apply(sx, sy, q, tx, ty, 3.0)
    assert torch.equal(out, kernels.mh_slp_apply_plain(sx, sy, q, tx, ty, 3.0))
    g = kernels.laplace_slp_grad_apply(sx, sy, q, tx, ty)
    for a, b in zip(g, kernels.laplace_slp_grad_apply_plain(sx, sy, q, tx, ty)):
        assert torch.equal(a, b)
    assert (kernels.mh_slp_apply.launches,
            kernels.laplace_slp_grad_apply.launches) == before
    for bad_k in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="k must be"):
            kernels.mh_slp_apply(sx, sy, q, tx, ty, bad_k)
    with pytest.raises(TypeError):
        kernels.mh_slp_apply(sx.float(), sy, q, tx, ty, 1.0)
    with pytest.raises(ValueError):
        kernels.laplace_slp_grad_apply(sx, sy, q[:-1], tx, ty)
    # coincident pair: r^2 clamped at 1e-30, the sums stay finite
    tx[0], ty[0] = sx[3], sy[3]
    assert torch.isfinite(kernels.mh_slp_apply(sx, sy, q, tx, ty, 2.0)).all()
    assert all(torch.isfinite(a).all()
               for a in kernels.laplace_slp_grad_apply(sx, sy, q, tx, ty))


# ---------------------------------------------------------------------------
# the slices, from one saved geometry
# ---------------------------------------------------------------------------

def _build(k, neumann):
    """The problem solved by ipde_tpu (dense grid backend), and the port's
    solver and BIE built from the saved geometry.  k None: Poisson."""
    h = tt.one_body_h(ENTRY[0])
    jc, tc = tt.paired_collections(ENTRY, h)
    pde = "poisson" if k is None else "mh"
    bc = grad_sol if neumann else sol
    ref = tt.reference_solve(ENTRY, h, pde, (_forcing(k),), (bc,), k=k,
                             neumann=neumann)
    tbc = BoundaryFunction([torch.tensor(np.asarray(v))
                            for v in ref["jbc"][0].values])
    return dict(jc=jc, js=ref["js"], jb=ref["jb"], jue_raw=ref["jraw"],
                jue=ref["jue"], jst=ref["jst"], tc=tc,
                ts=tt.port_solver(ENTRY, h, pde, k=k),
                tb=tt.port_bie(ENTRY, h, pde, k=k, neumann=neumann),
                tf=EmbeddedFunction.load(ref["jf"][0].save(), "cpu"),
                tbc=tbc)


@pytest.fixture(scope="module")
def mh_dirichlet():
    return _build(2.0, neumann=False)


@pytest.fixture(scope="module")
def mh_neumann():
    return _build(20.0, neumann=True)


def test_annular_mh_matvec_and_precond(mh_dirichlet):
    jh, th = mh_dirichlet["js"].helpers[0], mh_dirichlet["ts"].helpers[0]
    assert isinstance(th.annular_solver, ann.AnnularModifiedHelmholtzSolver)
    jops = jh.annular_solver.make_ops(jh.metric)
    tops = th.annular_solver.make_ops(th.metric)
    assert tops.helm_k2 == 4.0
    Mr, n = th.annular_solver.M, th.annular_solver.n
    assert np.array_equal(_np(jops.Kinv), _np(tops.Kinv))
    rng = np.random.default_rng(15)
    for _ in range(2):
        u = rng.standard_normal(Mr * n)
        assert _rel(ann._matvec(tops, torch.as_tensor(u), Mr, n),
                    jann._matvec(jops, jnp.asarray(u), Mr, n)) < 1e-13
        assert _rel(ann._precond(tops, torch.as_tensor(u), Mr, n),
                    jann._precond(jops, jnp.asarray(u), Mr, n)) < 1e-13


def test_annular_mh_solver_alone():
    """AnnularModifiedHelmholtzSolver built directly, as ipde_tpu's is:
    the same per-mode inverses, Robin rows included."""
    e = EmbeddedBoundary(star(64, a=0.1, f=3), True, 8, 0.05)
    dims = (64, 8, e.lb, e.ub, e.approximate_radius)
    bc = dict(la=1.0, lb_c=0.5, ua=2.0, ub_c=-0.25)
    tsol = ann.AnnularModifiedHelmholtzSolver(AnnularGeometry(*dims), 3.0,
                                              device="cpu", **bc)
    jsol = jann.AnnularModifiedHelmholtzSolver(JAG(*dims), 3.0, **bc)
    assert tsol.helmholtz_k == 3.0
    assert np.array_equal(_np(tsol.ops_static["Kinv"]),
                          _np(jsol.ops_static["Kinv"]))
    assert np.array_equal(_np(tsol.ops_static["row_ub"]),
                          _np(jsol.ops_static["row_ub"]))


def test_mh_qfs_maps_bit_equal(mh_dirichlet, mh_neumann):
    for p in (mh_dirichlet, mh_neumann):
        jh, th = p["js"].helpers[0], p["ts"].helpers[0]
        # the QFS sources moved by the Yukawa shift alpha
        assert np.array_equal(jh.grid_source.x, th.grid_source.x)
        assert np.array_equal(jh.radial_source.y, th.radial_source.y)
        pairs = [(jh.qfs_g, th.qfs_g), (jh.qfs_r, th.qfs_r)]
        pairs += list(zip(p["jb"].qfs_list, p["tb"].qfs_list))
        for jq, tq in pairs:
            assert len(jq.mats) == len(tq.mats)
            for jm, tm in zip(jq.mats, tq.mats):
                assert np.array_equal(_np(jm), _np(tm))
        assert np.array_equal(_np(jh.qfs_r.u2s_mat), _np(th.qfs_r.u2s_mat))
        assert np.array_equal(_np(jh.own_src_to_ifc), _np(th.own_src_to_ifc))
        assert np.array_equal(_np(p["jb"].Ainv), _np(p["tb"].Ainv))
    # mh_qfs called directly, SLP only, as NeumannBIE builds it
    e = mh_neumann["tc"].ebdys[0]
    src = e.qfs_source_for_side("bdy", True, alpha=2.0)
    from ipde_tpu.qfs.qfs import mh_qfs as jmh_qfs
    jq = jmh_qfs(e.bdy, src, True, 20.0, slp=True, dlp=False)
    tq = tqfs.mh_qfs(e.bdy, src, True, 20.0, slp=True, dlp=False,
                     device="cpu")
    assert len(tq.mats) == 1
    assert np.array_equal(_np(jq.mats[0]), _np(tq.mats[0]))
    assert np.array_equal(_np(jq.u2s_mat), _np(tq.u2s_mat))


# the Neumann correction at k = 20 goes through the normal-derivative BIE
# inverse and QFS maps built on the 9-fold oversampled self forms, whose
# norms are ~10x the Dirichlet ones: 1e-12 there (measured 1.1e-13)
@pytest.mark.parametrize("which,tol", [("mh_dirichlet", 1e-13),
                                       ("mh_neumann", 1e-12)])
def test_bie_apply_bc(which, tol, request):
    p = request.getfixturevalue(which)
    # the BIE correction of one and the same inhomogeneous solution
    ue = EmbeddedFunction.load(p["jue_raw"].save(), "cpu")
    got = p["tb"].apply_bc(ue, p["tbc"])
    assert _rel(got.grid, p["jue"].grid) < tol
    assert _rel(got.radials[0], p["jue"].radials[0]) < tol


@pytest.mark.parametrize("which", ["mh_dirichlet", "mh_neumann"])
def test_whole_mh_slice_matches_reference(which, request):
    p = request.getfixturevalue(which)
    ts, tb = p["ts"], p["tb"]
    assert ts.grid_backend == "dense"
    ue_raw, st = ts.solve_with_stats(p["tf"], **SOLVE)
    ue = tb.apply_bc(ue_raw, p["tbc"])
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert abs(st["annular_iterations"][0]
               - int(p["jst"]["annular_iterations"][0])) <= 1
    # GMRES stops at 1e-12 and the sums are ordered differently: 1e-10
    # absolute on an O(1) solution (measured 1.1e-13 Dirichlet k = 2,
    # 3.1e-13 Neumann k = 20)
    jue = p["jue"]
    diff = max(np.abs(_np(ue.grid) - _np(jue.grid)).max(),
               np.abs(_np(ue.radials[0]) - _np(jue.radials[0])).max())
    print(f"{which}: max |port - ipde_tpu| = {diff:.3e}")
    assert diff <= 1e-10
    terr, jerr = _mms_err(ts.ebdyc, ue), _mms_err(p["jc"], jue)
    assert 0.5 * jerr <= terr <= 2.0 * jerr, (terr, jerr)


def test_laplace_neumann_matches_reference():
    p = _build(None, neumann=True)
    jb, tb = p["jb"], p["tb"]
    assert np.array_equal(_np(jb.Ainv), _np(tb.Ainv))
    assert len(tb.qfs_list[0].mats) == 1          # SLP-only QFS
    ue_raw, _ = p["ts"].solve_with_stats(p["tf"], **SOLVE)
    ue = tb.apply_bc(ue_raw, p["tbc"])
    jue = p["jue"]
    diff = max(np.abs(_np(ue.grid) - _np(jue.grid)).max(),
               np.abs(_np(ue.radials[0]) - _np(jue.radials[0])).max())
    print(f"laplace neumann: max |port - ipde_tpu| = {diff:.3e}")
    assert diff <= 1e-10


# ---------------------------------------------------------------------------
# the port alone: the MMS asserts of the JAX package's own tests
# ---------------------------------------------------------------------------

# Both cases run the plain torch Yukawa sum over ~1e8-7e8 pairs: 4 s and
# 16 s in a process of their own on 8 threads, 27 s and 87 s on one, but
# 820 s and 798 s beside the other workers of the 6-worker tier-1 command
# (oversubscribed threads), so both are marked slow.
@pytest.mark.slow
@pytest.mark.parametrize("nb,Mr,neumann,limit", [
    (800, 20, False, 2.5e-10),    # tests/test_interior_mh.py
    (400, 16, True, 2e-9),        # tests/test_neumann.py
])
def test_port_mms(nb, Mr, neumann, limit):
    k = 2.0
    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / Mr)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, Mr, bh, qfs_tolerance=1e-14)],
        device="cpu")
    ebdyc.generate_grid(bh)
    solver = ModifiedHelmholtzSolver(ebdyc, k=k)
    if neumann:
        ux, uy = grad_sol(bdy.x, bdy.y)
        bc = BoundaryFunction(
            [torch.as_tensor(ux * bdy.normal_x + uy * bdy.normal_y)])
        bie = NeumannBIE(solver)
    else:
        bc = BoundaryFunction.from_function(ebdyc, sol)
        bie = DirichletBIE(solver)
    f = EmbeddedFunction.from_function(
        ebdyc, lambda x, y: k ** 2 * sol(x, y) - lap_sol(x, y))
    ue = bie.apply_bc(solver(f, tol=1e-12), bc)
    err = _mms_err(ebdyc, ue)
    print(f"port MMS nb={nb} M={Mr} neumann={neumann}: error {err:.3e}")
    assert err < limit


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("T,S,seed,k", [(700, 300, 5, 1.0), (700, 300, 5, 20.0),
                                        (70001, 3001, 4, 2.0), (1, 1, 6, 2.0),
                                        (257, 255, 7, 100.0)])
def test_cuda_kernels_match_plain(T, S, seed, k):
    dev = _cuda()
    sx, sy, q, tx, ty = (torch.as_tensor(a, device=dev)
                         for a in cloud(T=T, S=S, seed=seed))
    before = kernels.mh_slp_apply.launches
    got = kernels.mh_slp_apply(sx, sy, q, tx, ty, k)
    torch.cuda.synchronize()
    assert kernels.mh_slp_apply.launches == before + 1
    want = kernels.mh_slp_apply_plain(sx, sy, q, tx, ty, k)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    before = kernels.laplace_slp_grad_apply.launches
    g = kernels.laplace_slp_grad_apply(sx, sy, q, tx, ty)
    torch.cuda.synchronize()
    assert kernels.laplace_slp_grad_apply.launches == before + 1
    w = kernels.laplace_slp_grad_apply_plain(sx, sy, q, tx, ty)
    scale = (w[0].abs() + w[1].abs()).clamp_min(1.0)
    for a, b in zip(g, w):
        assert float(((a - b).abs() / scale).max()) <= 1e-12


def _grid_cloud(n, k, seed):
    """An n x n box grid in [-1.5, 1.5]^2 (row-major) around a 600-source
    star-like curve of radius ~1: at k = 100 most (warp, 32-source) tiles
    are out of reach."""
    rng = np.random.default_rng(seed)
    S = 600
    th = 2 * np.pi * np.arange(S) / S
    rad = 1.0 + 0.2 * np.cos(5 * th)
    g = np.linspace(-1.5, 1.5, n)
    tx, ty = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    return (rad * np.cos(th), rad * np.sin(th), rng.standard_normal(S) / S,
            tx.copy(), ty.copy())


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,seed,k", [(5400, 900, 5, 100.0),
                                        (8000, 2400, 6, 2.0),
                                        (270336, 300, 7, 20.0),
                                        (270337, 300, 7, 20.0),
                                        (8193, 1023, 8, 2.0),
                                        (33, 31, 9, 1.0)])
def test_cuda_kernel_split_and_ragged_shapes(T, S, seed, k):
    """Launches on either side of the split threshold (sources split across
    blocks up to 270,336 targets) and with T and S that are multiples of no
    tile: within 1e-12 of the plain version, and two runs bit-equal."""
    dev = _cuda()
    args = [torch.as_tensor(a, device=dev)
            for a in cloud(T=T, S=S, seed=seed)]
    if S >= 64:
        assert (kernels.split_count("mh_slp", T, S) > 1) == (T <= 270336)
    got = kernels.mh_slp_apply(*args, k)
    again = kernels.mh_slp_apply(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = kernels.mh_slp_apply_plain(*args, k)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("k,order", [(100.0, "row_major"), (100.0, "sorted"),
                                     (100.0, "shuffled"), (2.0, "sorted"),
                                     (2.0, "shuffled")])
def test_cuda_kernel_any_target_order_and_skip(k, order):
    """The kernel is right for any target order: spatially sorted (where at
    k = 100 most source tiles are skipped), row-major and shuffled."""
    dev = _cuda()
    sx, sy, q, tx, ty = (torch.as_tensor(a, device=dev)
                         for a in _grid_cloud(192, k, 3))
    if order == "sorted":
        perm = kernels.spatial_order(tx, ty, cell=3.0 / 191)
    elif order == "shuffled":
        perm = torch.as_tensor(np.random.default_rng(4).permutation(
            tx.shape[0]), device=dev)
    else:
        perm = torch.arange(tx.shape[0], device=dev)
    tx, ty = tx[perm].contiguous(), ty[perm].contiguous()
    got = kernels.mh_slp_apply(sx, sy, q, tx, ty, k)
    want = kernels.mh_slp_apply_plain(sx, sy, q, tx, ty, k)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    # zero where the plain version is zero: a skipped pair adds nothing
    assert torch.equal(got == 0, want == 0)


@pytest.mark.gpu
def test_cuda_kernel_carries_nan():
    dev = _cuda()
    sx, sy, q, tx, ty = (torch.as_tensor(a, device=dev)
                         for a in _grid_cloud(64, 100.0, 3))
    perm = kernels.spatial_order(tx, ty)
    tx, ty = tx[perm].contiguous(), ty[perm].contiguous()
    tx[1234] = float("nan")
    out = kernels.mh_slp_apply(sx, sy, q, tx, ty, 100.0)
    assert torch.isnan(out).nonzero().flatten().tolist() == [1234]
    tx[1234] = 0.0
    q[7] = float("nan")      # 0 * NaN in the plain version: every target
    assert torch.isnan(kernels.mh_slp_apply(sx, sy, q, tx, ty, 100.0)).all()


@pytest.mark.gpu
def test_mh_slice_on_cuda_matches_cpu(monkeypatch):
    """MH + DirichletBIE (k = 2) and + NeumannBIE (k = 20) on
    star(128, a=0.1, f=3), M=8, on the GPU and on the CPU."""
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    dev = _cuda()
    for k, bie_cls in ((2.0, DirichletBIE), (20.0, NeumannBIE)):
        out = {}
        for d in ("cpu", dev):
            bdy = star(NB, a=0.1, f=3)
            bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
            ebdyc = EmbeddedBoundaryCollection(
                [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
                device=d)
            ebdyc.generate_grid(bh)
            solver = ModifiedHelmholtzSolver(ebdyc, k=k)
            bie = bie_cls(solver)
            if bie_cls is NeumannBIE:
                ux, uy = grad_sol(bdy.x, bdy.y)
                bc = BoundaryFunction([torch.as_tensor(
                    ux * bdy.normal_x + uy * bdy.normal_y, device=d)])
            else:
                bc = BoundaryFunction.from_function(ebdyc, sol)
            f = EmbeddedFunction.from_function(
                ebdyc, lambda x, y: k ** 2 * sol(x, y) - lap_sol(x, y))
            before = kernels.mh_slp_apply.launches
            ue = bie.apply_bc(solver(f, **SOLVE), bc)
            out[str(d)] = (_np(ue.grid), _np(ue.radials[0]),
                           kernels.mh_slp_apply.launches - before)
        (gc, rc, nc), (gg, rg, ng) = out["cpu"], out[str(dev)]
        assert nc == 0 and ng > 0
        assert np.abs(gc - gg).max() <= 1e-11
        assert np.abs(rc - rg).max() <= 1e-11
