"""The port's scalar solvers and BIEs on several boundaries against ipde_tpu:
the three-body modified Helmholtz problem of tests/test_multi_body.py (one
interior star, two inclusions of another (M, n): the per-boundary GMRES
loop) with DirichletBIE and NeumannBIE, dense grid backend, and the
exterior geometry operators of tests/test_exterior.py.  The Poisson problem
with one inclusion (the batched GMRES, fft grid backend), the batched
solves and the helper reuse are in tests/test_torch_batched.py.  Both
packages are built from one saved geometry, at small sizes (M = 6).
Marker ``gpu``: the same solve on the card against the CPU, skipped with a
reason where torch sees no CUDA device.

The port takes every source in the BIE's radial plans of an inclusion and
of another boundary (``solvers/bie.py::_radial_plans``); ipde_tpu subsamples
them, which costs its three-body Stokes problem three orders of accuracy.
The reference BIEs here are given the port's plans (``_plans_as_port``),
built by ipde_tpu's own StratifiedRadialApply.

Tolerances: solutions to 1e-10 of max |ipde_tpu| (GMRES stops at 1e-12 and
the sums run in another order), GMRES iterations within one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np, mms_err
from _torch_testing import cuda_or_skip as _cuda
from _torch_testing import mgrad as grad_sol, msol as sol
from _torch_testing import one_torch_thread  # noqa: F401
from _torch_testing import plans_as_port as _plans_as_port
from _torch_testing import rel_gap as _gap
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.solvers.bie import DirichletBIE as JDBIE
from ipde_tpu.solvers.bie import NeumannBIE as JNBIE
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.solvers import scalar as tscalar
from ipde_tpu_torch.solvers.bie import DirichletBIE, NeumannBIE
from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver

KH = 2.0


def _mh3_collection(nb=48, M=6):
    """tests/test_multi_body.py's geometry at nb=48 (72 + 48 + 48 points):
    (Bodies, h)."""
    bodies = (tt.body(3 * nb // 2, M, qfs_tolerance=1e-14, a=0.1, f=5,
                      r=2.0),
              tt.body(nb, M, False, 1e-14, x=-0.8, y=-0.5, a=0.1, f=3,
                      r=0.45),
              tt.body(nb, M, False, 1e-14, "squished_circle", x=0.7, y=0.6,
                      r=0.5, b=0.7, rot=np.pi / 5))
    curves = [tt.jcurve(b) for b in bodies]
    kmax = max(np.abs(b.curvature).max() for b in curves)
    return bodies, min(min(b.min_h() for b in curves), 0.6 / kmax / M)


@pytest.fixture(scope="module")
def mh3():
    """Three-body Yukawa, k = 2, dense grid backend, solved by ipde_tpu;
    the port's solver from the saved geometry; both packages' DirichletBIE
    (ipde_tpu's own radial strides kept aside, then the port's plans)."""
    bodies, bh = _mh3_collection()
    jc, tc = tt.paired_collections(bodies, bh)
    js = tt.reference_solver(bodies, bh, "mh", k=KH)
    jf = JEF.from_function(jc, tt.mh_forcing(KH))
    jraw, jst = js.solve_with_stats(jf, **SOLVE)
    jd = JDBIE(js)
    jstrides = [[p.strides.copy() for p in row] for row in jd.radial_plans]
    ts = ModifiedHelmholtzSolver(tc, k=KH, grid_backend="dense")
    tf = EmbeddedFunction.load(jf.save(), "cpu")
    traw, tst = ts.solve_with_stats(tf, **SOLVE)
    # du/dn of the manufactured solution on each boundary
    bcn = tt.normal_derivative(tc, grad_sol)
    return dict(jc=jc, js=js, jraw=jraw, jst=jst, jd=_plans_as_port(jd),
                jstrides=jstrides, tc=tc, ts=ts, tf=tf, traw=traw, tst=tst,
                td=DirichletBIE(ts), jbc=JBF.from_function(jc, sol),
                tbc=BoundaryFunction.from_function(tc, sol), bcn=bcn)


def test_three_body_mh_solve(mh3, monkeypatch):
    tc, raw, st = mh3["tc"], mh3["traw"], mh3["tst"]
    assert [e.interior for e in tc] == [True, False, False]
    assert max(st["annular_residuals"]) <= SOLVE["tol"]
    assert len(st["annular_iterations"]) == 3
    for a, b in zip(st["annular_iterations"],
                    mh3["jst"]["annular_iterations"]):
        assert abs(a - int(b)) <= 1
    assert _gap(raw, mh3["jraw"], tc.phys) <= 1e-10
    # two (M, n) among the boundaries: the per-boundary loop, as ipde_tpu
    calls = []
    monkeypatch.setattr(tscalar, "batched_annular_solve",
                        lambda *a: calls.append(1))
    mh3["ts"].solve_with_stats(mh3["tf"], **SOLVE)
    assert calls == []


def test_three_body_mh_dirichlet(mh3):
    want = mh3["jd"].apply_bc(mh3["jraw"], mh3["jbc"])
    got = mh3["td"].apply_bc(mh3["traw"], mh3["tbc"])
    tc = mh3["tc"]
    assert _gap(got, want, tc.phys) <= 1e-10
    # the manufactured solution, to the accuracy ipde_tpu reaches
    err, jerr = mms_err(tc, got, sol), mms_err(tc, want, sol)
    assert err <= 1.01 * jerr + 1e-12


def test_three_body_mh_neumann(mh3):
    jb = _plans_as_port(JNBIE(mh3["js"]))
    want = jb.apply_bc(mh3["jraw"], JBF([jnp.asarray(v) for v in mh3["bcn"]]))
    got = NeumannBIE(mh3["ts"]).apply_bc(
        mh3["traw"], BoundaryFunction([torch.as_tensor(v)
                                       for v in mh3["bcn"]]))
    tc = mh3["tc"]
    assert _gap(got, want, tc.phys) <= 1e-10
    assert mms_err(tc, got, sol) <= 1.01 * mms_err(tc, want, sol) + 1e-12


def test_ipde_tpu_subsamples_the_cross_plans(mh3):
    """ipde_tpu's own plans subsample the inclusions' rows; the port's
    take every source there (the fault the port repairs)."""
    jstrides = mh3["jstrides"]
    assert any(max(s) > 1 for i, row in enumerate(jstrides)
               for j, s in enumerate(row) if (i, j) != (0, 0))
    for i, row in enumerate(mh3["td"].radial_plans):
        for j, plan in enumerate(row):
            if (i, j) == (0, 0):
                assert np.array_equal(plan.strides, jstrides[0][0])
            else:
                assert list(plan.strides) == [1] * len(plan.strides)


def test_exterior_geometry_ops():
    """tests/test_exterior.py::test_exterior_geometry_ops on the port, and
    its interpolation rows against ipde_tpu's."""
    nb, M = 300, 10
    jb = jstar(nb, x=np.pi, y=np.pi, a=0.1, f=3, r=0.9)
    bh = min(jb.min_h(), 0.6 / np.abs(jb.curvature).max() / M)
    je = JEB(jb, False, M, bh)
    e = load_collection({"ebdys": [je.save()]}, "cpu").ebdys[0]
    bdy = e.bdy
    assert not e.interior and e.lb == 0.0 and e.ub > 0.0
    assert (e.lb, e.ub) == (je.lb, je.ub)
    F = lambda x, y: np.sin(x) * np.cos(y)  # noqa: E731
    fr = F(e.radial_x, e.radial_y)
    fb = _np(e.interpolate_radial_to_boundary(fr))
    assert np.abs(fb - F(bdy.x, bdy.y)).max() < 1e-10
    fi = _np(e.interpolate_radial_to_interface(fr))
    assert np.abs(fi - F(e.interface.x, e.interface.y)).max() < 1e-10
    FX = lambda x, y: np.cos(x) * np.cos(y)  # noqa: E731
    FY = lambda x, y: -np.sin(x) * np.sin(y)  # noqa: E731
    fn = _np(e.interpolate_radial_to_boundary_normal_derivative(fr))
    exact = FX(bdy.x, bdy.y) * bdy.normal_x + FY(bdy.x, bdy.y) * bdy.normal_y
    assert np.abs(fn - exact).max() < 1e-7
    for name in ("interp_f_to_bdy", "interp_f_to_interface",
                 "interp_dn_to_bdy", "interp_dn_to_interface"):
        got, want = _np(getattr(e, name)), np.asarray(getattr(je, name))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["dense", "fft"])
def test_three_body_mh_on_cuda_matches_cpu(mh3, backend, monkeypatch):
    """The three-body Yukawa Dirichlet solve on the card and on the CPU,
    with every mh_slp launch of the card's run held to the plain version."""
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    from ipde_tpu_torch.ops import kernels as K
    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        tc = load_collection(mh3["jc"].save(), d)
        tc.generate_grid(tc.ebdys[0].h)
        ts = ModifiedHelmholtzSolver(tc, k=KH, grid_backend=backend)
        bie = DirichletBIE(ts)
        f = EmbeddedFunction.from_function(tc, tt.mh_forcing(KH))
        calls = []
        orig = K.mh_slp_apply

        def rec(*a):
            calls.append(a)
            return orig(*a)

        rec.launches = orig.launches
        K.mh_slp_apply = rec
        try:
            ue = bie.apply_bc(ts(f, **SOLVE),
                              BoundaryFunction.from_function(tc, sol))
        finally:
            K.mh_slp_apply = orig
        out[str(d)] = (ue, calls, tc.phys)
    (cpu, _, phys), (gpu, calls, _) = out["cpu"], out["cuda:0"]
    assert _gap(gpu, cpu, phys) <= 1e-10
    assert calls
    for a in calls:
        got, want = K.mh_slp_apply(*a), K.mh_slp_apply_plain(*a)
        assert float((got - want).abs().max()) <= \
            1e-12 * float(want.abs().max())


