"""The port's solver_type="fourth" (4th-order finite-difference grid
derivatives and 3rd-order polynomial interface interpolation) against
ipde_tpu's on the same saved geometry: Poisson with one inclusion of the
interior boundary's (M, n) (the lockstep GMRES) and DirichletBIE, Yukawa
(k = 2) with NeumannBIE, Stokes with StokesDirichletBIE, each on ipde_tpu's
dense grid backend; the port's fft backend against its dense one on the
same problems.  Marker ``gpu``: one fourth-order solve on the card against
the CPU, skipped with a reason where torch sees no CUDA device.

The reference BIEs are given the port's radial plans (every source except
on an interior boundary's own rows; tests/test_torch_multi_body.py).

Tolerances: solutions to 1e-10 of max |ipde_tpu| (GMRES stops at 1e-12 and
the sums run in another order), GMRES iterations within one; the two grid
backends of the port to 1e-10 (the FFT evaluator is within ~1e-15 of the
dense kernel)."""

import numpy as np
import pytest
import torch

import _torch_testing as tt
from _torch_testing import SOLVE, fuf, fvf, msol, pfrc, psol, usol, vsol
from _torch_testing import one_torch_thread  # noqa: F401
from _torch_testing import rel_gap as _gap
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.solvers import scalar as tscalar
from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                        StokesDirichletBIE)
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

KH = 2.0


def mfrc(x, y):
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    return KH**2 * msol(x, y) - (u1xx - 4 * u1 - 3.0 * np.cos(3 * x)
                                 * np.cos(y))


def _iters_close(st, jst):
    return all(abs(a - int(b)) <= 1 for a, b in
               zip(st["annular_iterations"], jst["annular_iterations"]))


@pytest.fixture(scope="module")
def poisson2():
    """Poisson with one inclusion of the interior boundary's (n, M), solved
    by ipde_tpu with solver_type="fourth" (dense grid backend)."""
    bodies, bh = tt.two_body()
    _, tc = tt.paired_collections(bodies, bh)
    ref = tt.reference_solve(bodies, bh, "poisson", (pfrc,), (psol,),
                             solver_type="fourth", port_plans=True)
    return dict(jraw=ref["jraw"], jst=ref["jst"], juf=ref["jue"], tc=tc,
                tf=EmbeddedFunction.load(ref["jf"][0].save(), "cpu"),
                tbc=BoundaryFunction.from_function(tc, psol))


@pytest.mark.parametrize("backend", ["dense", "fft"])
def test_fourth_poisson_inclusion_lockstep(poisson2, backend, monkeypatch):
    p = poisson2
    tc = p["tc"]
    ts = PoissonSolver(tc, grid_backend=backend, solver_type="fourth")
    calls = []
    orig = tscalar.batched_annular_solve
    monkeypatch.setattr(tscalar, "batched_annular_solve",
                        lambda *a: calls.append(1) or orig(*a))
    raw, st = ts.solve_with_stats(p["tf"], **SOLVE)
    assert calls == [1]
    assert max(st["annular_residuals"]) <= SOLVE["tol"]
    assert _iters_close(st, p["jst"])
    assert _gap(raw, p["jraw"], tc.phys) <= 1e-10
    got = DirichletBIE(ts).apply_bc(raw, p["tbc"])
    assert _gap(got, p["juf"], tc.phys) <= 1e-10


@pytest.fixture(scope="module")
def mh():
    """Yukawa k = 2, one boundary, Neumann data, ipde_tpu's fourth solve
    (dense grid backend)."""
    bodies = (tt.body(64, 6, qfs_tolerance=1e-14, a=0.1, f=5),)
    bh = tt.one_body_h(bodies[0])
    _, tc = tt.paired_collections(bodies, bh)
    ref = tt.reference_solve(bodies, bh, "mh", (mfrc,), (tt.mgrad,), k=KH,
                             neumann=True, solver_type="fourth",
                             port_plans=True)
    return dict(jraw=ref["jraw"], jst=ref["jst"], juf=ref["jue"], tc=tc,
                tf=EmbeddedFunction.load(ref["jf"][0].save(), "cpu"),
                tbc=BoundaryFunction([torch.as_tensor(v)
                                      for v in ref["jbc"][0].values]))


@pytest.mark.parametrize("backend", ["dense", "fft"])
def test_fourth_yukawa_neumann(mh, backend):
    tc = mh["tc"]
    ts = ModifiedHelmholtzSolver(tc, k=KH, grid_backend=backend,
                                 solver_type="fourth")
    raw, st = ts.solve_with_stats(mh["tf"], **SOLVE)
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert _iters_close(st, mh["jst"])
    assert _gap(raw, mh["jraw"], tc.phys) <= 1e-10
    got = NeumannBIE(ts).apply_bc(raw, mh["tbc"])
    assert _gap(got, mh["juf"], tc.phys) <= 1e-10


@pytest.fixture(scope="module")
def stokes():
    """Stokes, one boundary, ipde_tpu's fourth solve (dense grid
    backend)."""
    bodies = (tt.body(64, 6, a=0.1, f=5),)
    bh = tt.one_body_h(bodies[0])
    _, tc = tt.paired_collections(bodies, bh)
    ref = tt.reference_solve(bodies, bh, "stokes", (fuf, fvf), (usol, vsol),
                             solver_type="fourth")
    jfu, jfv = ref["jf"]
    return dict(jraw=ref["jraw"], jst=ref["jst"], juvp=ref["jue"], tc=tc,
                tfu=EmbeddedFunction.load(jfu.save(), "cpu"),
                tfv=EmbeddedFunction.load(jfv.save(), "cpu"),
                tbu=BoundaryFunction.from_function(tc, usol),
                tbv=BoundaryFunction.from_function(tc, vsol))


@pytest.mark.parametrize("backend", ["dense", "fft"])
def test_fourth_stokes(stokes, backend):
    tc = stokes["tc"]
    ts = StokesSolver(tc, grid_backend=backend, solver_type="fourth")
    raw, st = ts.solve_with_stats(stokes["tfu"], stokes["tfv"], **SOLVE)
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert _iters_close(st, stokes["jst"])
    for g, w, sh in zip(raw, stokes["jraw"], (False, False, True)):
        assert _gap(g, w, tc.phys, sh) <= 1e-10
    got = StokesDirichletBIE(ts).apply_bc(*raw, stokes["tbu"], stokes["tbv"])
    for g, w, sh in zip(got, stokes["juvp"], (False, False, True)):
        assert _gap(g, w, tc.phys, sh) <= 1e-10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_fourth_poisson_on_cuda_matches_cpu(poisson2, monkeypatch):
    """The fourth-order Poisson solve with an inclusion on the card against
    the CPU, with laplace_slp launches from the card's run."""
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from ipde_tpu_torch.ops import kernels as K
    out = {}
    for d in ("cpu", "cuda"):
        tc = load_collection(poisson2["tc"].save(), d)
        tc.generate_grid(tc.ebdys[0].h)
        ts = PoissonSolver(tc, solver_type="fourth")
        f = EmbeddedFunction.from_function(tc, pfrc)
        K.laplace_slp_apply.launches = 0
        out[d] = DirichletBIE(ts).apply_bc(
            ts(f, **SOLVE), BoundaryFunction.from_function(tc, psol))
        out[d + "_launches"] = K.laplace_slp_apply.launches
        out[d + "_phys"] = tc.phys
    assert _gap(out["cuda"], out["cpu"], out["cpu_phys"]) <= 1e-10
    assert out["cuda_launches"] > 0
