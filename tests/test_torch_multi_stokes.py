"""The port's Stokes solver and BIE on several boundaries against ipde_tpu:
the three-body problem of examples/stokes_refinement.py (one interior star,
two inclusions of another (M, n): the per-boundary GMRES loop) at nb=64,
M=6, inclusions of 32 points, M=4, and a two-body problem whose inclusion
has the interior boundary's (M, n) (the batched annular Stokes GMRES), with
StokesDirichletBIE: solve and apply_bc, the BIE matrix, an inclusion
helper's densities and correction, ``batched_stokes_solve`` against
ipde_tpu's and against the per-boundary loop.  Both packages are built from
one saved geometry; ipde_tpu on the dense grid backend, the port on the
dense one for three bodies and the fft one for two (its FFT evaluators are
held to ipde_tpu's in tests/test_torch_grid_eval.py).
Marker ``gpu``: the three-body solve on the card against the CPU, and every
stokes_slp launch of it against the plain version.

The reference BIE is given the port's radial plans (every source except on
an interior boundary's own rows; see tests/test_torch_multi_body.py).

Tolerances: u, v to 1e-10 of max |ipde_tpu|, p to 1e-10 after the mean of
the difference over the physical grid points is removed (the pressure is
defined up to a constant); single host-composed maps to 1e-13; GMRES
iterations within one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np, rel as _rel
from _torch_testing import cuda_or_skip as _cuda
from _torch_testing import fuf, fvf, usol, vsol
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.solvers import annular_stokes as jann
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.solvers import annular_stokes as ann
from ipde_tpu_torch.solvers import vector as tvector
from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
from ipde_tpu_torch.solvers.vector import StokesSolver

def _uvp_gap(got, want, phys):
    """max over u, v of |got - want| relative to max |want|, and for p the
    same after the mean of the difference over the physical grid points is
    removed; physical grid points and every radial grid."""
    out = []
    for k, (g, w) in enumerate(zip(got, want)):
        dg = _np(g.grid) - _np(w.grid)
        c = dg[phys].mean() if k == 2 else 0.0
        scale = max(np.abs(_np(w.grid))[phys].max(),
                    max(np.abs(_np(r)).max() for r in w.radials))
        gap = max(np.abs(dg - c)[phys].max(),
                  max(np.abs(_np(a) - _np(b) - c).max()
                      for a, b in zip(g.radials, w.radials)))
        out.append(gap / scale)
    return out


def _problem(bodies, bh):
    """ipde_tpu's dense solve + BIE (port's plans) of the Bodies
    ``bodies``, and the port's collection and data from the saved
    geometry."""
    jc, tc = tt.paired_collections(bodies, bh)
    ref = tt.reference_solve(bodies, bh, "stokes", (fuf, fvf), (usol, vsol),
                             port_plans=True)
    jfu, jfv = ref["jf"]
    return dict(jc=jc, js=ref["js"], jb=ref["jb"], jraw=ref["jraw"],
                jst=ref["jst"], juvp=ref["jue"], tc=tc,
                tfu=EmbeddedFunction.load(jfu.save(), "cpu"),
                tfv=EmbeddedFunction.load(jfv.save(), "cpu"),
                tbc=(BoundaryFunction.from_function(tc, usol),
                     BoundaryFunction.from_function(tc, vsol)),
                solvers={})


def _port(p, backend):
    """The port's StokesSolver and StokesDirichletBIE of problem p."""
    if backend not in p["solvers"]:
        ts = StokesSolver(p["tc"], grid_backend=backend)
        p["solvers"][backend] = (ts, StokesDirichletBIE(ts))
    return p["solvers"][backend]


@pytest.fixture(scope="module")
def three():
    """examples/stokes_refinement.py::run_case's geometry at nb=64, M=6
    (inclusions of 32 points, M=4)."""
    nb, M, Mi = 64, 6, 4
    bodies = (tt.body(nb, M, a=0.1, f=3),
              tt.body(nb // 2, Mi, False, x=0.3, y=0.18, r=0.16, a=0.05,
                      f=4),
              tt.body(nb // 2, Mi, False, x=-0.28, y=-0.22, r=0.15, a=0.05,
                      f=3))
    outer = tt.jcurve(bodies[0])
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M,
             0.16 / M)
    return _problem(bodies, bh)


@pytest.fixture(scope="module")
def two():
    """An interior star and one inclusion of its (n, M) = (64, 6)."""
    return _problem(*tt.two_body())


def test_three_body_stokes(three, monkeypatch):
    p = three
    ts, tb = _port(p, "dense")
    calls = []
    monkeypatch.setattr(tvector, "batched_stokes_solve",
                        lambda *a: calls.append(1))
    raw, st = ts.solve_with_stats(p["tfu"], p["tfv"], **SOLVE)
    assert calls == []                  # two shapes: the per-boundary loop
    assert max(st["annular_residuals"]) <= SOLVE["tol"]
    assert len(st["annular_iterations"]) == 3
    for a, b in zip(st["annular_iterations"], p["jst"]["annular_iterations"]):
        assert abs(a - int(b)) <= 1
    assert max(_uvp_gap(raw, p["jraw"], p["tc"].phys)) <= 1e-10
    got = tb.apply_bc(*raw, *p["tbc"])
    assert max(_uvp_gap(got, p["juvp"], p["tc"].phys)) <= 1e-10


def test_two_body_stokes_batched(two, monkeypatch):
    p = two
    ts, tb = _port(p, "fft")
    calls = []
    orig = tvector.batched_stokes_solve
    monkeypatch.setattr(tvector, "batched_stokes_solve",
                        lambda *a: calls.append(1) or orig(*a))
    raw, st = ts.solve_with_stats(p["tfu"], p["tfv"], **SOLVE)
    assert calls == [1]
    assert [h.iterations_last_call for h in ts.helpers] == \
        st["annular_iterations"]
    assert max(st["annular_residuals"]) <= SOLVE["tol"]
    for a, b in zip(st["annular_iterations"], p["jst"]["annular_iterations"]):
        assert abs(a - int(b)) <= 1
    assert max(_uvp_gap(raw, p["jraw"], p["tc"].phys)) <= 1e-10
    got = tb.apply_bc(*raw, *p["tbc"])
    assert max(_uvp_gap(got, p["juvp"], p["tc"].phys)) <= 1e-10


def test_stokes_bie_matrix(three):
    """The inverse of the block BIE matrix (2N rows per boundary: the
    interior boundary's DLP + pressure fix, the inclusions' DLP + SLP) from
    the same host forms and LAPACK inverse."""
    jb = three["jb"]
    ts, tb = _port(three, "dense")
    assert list(tb.offs) == list(jb.offs)
    assert _rel(tb.Ainv, jb.Ainv) <= 1e-13
    for tq, jq in zip(tb.qfs_list, jb.qfs_list):
        assert len(tq.mats) == len(jq.mats)
        for tm, jm in zip(tq.mats, jq.mats):
            assert _rel(tm, jm) <= 1e-13


def test_inclusion_helper_densities_and_correct(three):
    jh = three["js"].helpers[1]
    th = _port(three, "dense")[0].helpers[1]
    assert not th.interior
    N = th.ebdy.bdy.N
    Mi = th.annular_solver.M
    rng = np.random.default_rng(41)
    uvp_rt = (rng.standard_normal((Mi, N)), rng.standard_normal((Mi, N)),
              rng.standard_normal((Mi, N)))
    ifc = rng.standard_normal((5, N))
    (ju, jv, jp), jsg, jsr = jh.densities(
        tuple(map(jnp.asarray, uvp_rt)), *map(jnp.asarray, ifc))
    (tu, tv, tp), tsg, tsr = th.densities(
        tuple(map(torch.as_tensor, uvp_rt)), *map(torch.as_tensor, ifc))
    for g, w in ((tu, ju), (tv, jv), (tp, jp), (tsg, jsg), (tsr, jsr)):
        assert _rel(g, w) <= 1e-13
    # the multi-boundary correction: u2s re-match of the other boundaries'
    # interface field, then sigma_r onto the radial grid
    assert _rel(th.own_src_to_ifc, jh.own_src_to_ifc) <= 1e-13
    assert _rel(th.qfs_r.u2s_mat, jh.qfs_r.u2s_mat) <= 1e-13
    bu, bv = rng.standard_normal((2, N))
    want = jh.correct((ju, jv, jp), jsg, jsr, jnp.asarray(bu),
                      jnp.asarray(bv), False)
    got = th.correct((tu, tv, tp), tsg, tsr, torch.as_tensor(bu),
                     torch.as_tensor(bv), False)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


def test_batched_stokes_solve_matches_reference(two):
    jh = two["js"].helpers
    th = _port(two, "dense")[0].helpers
    M, n = th[0].annular_solver.M, th[0].annular_solver.n
    rng = np.random.default_rng(42)
    fs = rng.standard_normal((2, 2, M, n))
    jr = [h.annular_rhs(*map(jnp.asarray, f)) for h, f in zip(jh, fs)]
    tr = [h.annular_rhs(*map(torch.as_tensor, f)) for h, f in zip(th, fs)]
    want, jst = jann.batched_stokes_solve(
        [h.annular_solver for h in jh], [h.metric for h in jh], jr,
        SOLVE["tol"], SOLVE["maxiter"], SOLVE["restart"])
    got, st = ann.batched_stokes_solve(
        [h.annular_solver for h in th], [h.metric for h in th], tr, **SOLVE)
    for g, w, it, jit, r, h, f in zip(got, want, st["iterations"],
                                      jst["iterations"], st["residual"], th,
                                      fs):
        assert r <= SOLVE["tol"] and abs(it - int(jit)) <= 1
        z = h.zero_bc
        one, ost = h.annular_solver.solve_with_stats(
            h.metric, *h.uv_to_rt(*map(torch.as_tensor, f)), z, z, z, z,
            **SOLVE)
        assert abs(ost["iterations"] - it) <= 1
        # ur, ut; p up to its constant
        for k in range(3):
            c = _np(g[k]).mean() - np.asarray(w[k]).mean() if k == 2 else 0
            scale = np.abs(np.asarray(w[k])).max()
            assert np.abs(_np(g[k]) - np.asarray(w[k]) - c).max() \
                <= 1e-10 * scale
            c = _np(g[k]).mean() - _np(one[k]).mean() if k == 2 else 0
            assert np.abs(_np(g[k]) - _np(one[k]) - c).max() <= 1e-10 * scale


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["dense", "fft"])
def test_three_body_stokes_on_cuda_matches_cpu(three, backend, monkeypatch):
    """The three-body solve + apply_bc on the card against the CPU, and each
    stokes_slp launch of the card's run (every distinct shape of this path)
    within 1e-12 of the plain version and bit-equal run to run."""
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    from ipde_tpu_torch.ops import stokes_kernels as sk
    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        tc = load_collection(three["jc"].save(), d)
        tc.generate_grid(tc.ebdys[0].h)
        ts = StokesSolver(tc, grid_backend=backend)
        tb = StokesDirichletBIE(ts)
        calls = []
        orig = sk.stokes_slp_apply

        def rec(*a):
            calls.append(a)
            return orig(*a)

        rec.launches = orig.launches
        sk.stokes_slp_apply = rec
        try:
            uvp = tb.apply_bc(
                *ts(EmbeddedFunction.from_function(tc, fuf),
                    EmbeddedFunction.from_function(tc, fvf), **SOLVE),
                BoundaryFunction.from_function(tc, usol),
                BoundaryFunction.from_function(tc, vsol))
        finally:
            sk.stokes_slp_apply = orig
        out[str(d)] = (uvp, calls, tc.phys)
    (cpu, _, phys), (gpu, calls, _) = out["cpu"], out["cuda:0"]
    assert max(_uvp_gap(gpu, cpu, phys)) <= 1e-10
    assert calls
    for a in calls:
        got, again = sk.stokes_slp_apply(*a), sk.stokes_slp_apply(*a)
        want = sk.stokes_slp_apply_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        for k, (g, w) in enumerate(zip(got, want)):
            scale = (w.abs().clamp_min(1.0) if k == 2
                     else w.abs().max().clamp_min(1e-300))
            assert float(((g - w).abs() / scale).max()) <= 1e-12
