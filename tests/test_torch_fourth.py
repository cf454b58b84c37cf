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

import jax.numpy as jnp
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.ops.stratified import StratifiedRadialApply as JSRA
from ipde_tpu.solvers.bie import DirichletBIE as JDBIE
from ipde_tpu.solvers.bie import NeumannBIE as JNBIE
from ipde_tpu.solvers.bie import StokesDirichletBIE as JSBIE
from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver as JMHS
from ipde_tpu.solvers.scalar import PoissonSolver as JPS
from ipde_tpu.solvers.vector import StokesSolver as JSS
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.solvers import scalar as tscalar
from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                        StokesDirichletBIE)
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

SOLVE = dict(tol=1e-12, maxiter=60, restart=30)
KH = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the tier-1 command runs six
    workers on eight cores; see tests/test_torch_multi_body.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def psol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def pfrc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


def msol(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y) + 0.3 * np.cos(3 * x) * np.cos(y)


def mfrc(x, y):
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    return KH**2 * msol(x, y) - (u1xx - 4 * u1 - 3.0 * np.cos(3 * x)
                                 * np.cos(y))


def mdn(bdy):
    """du/dn of msol on the boundary."""
    x, y = bdy.x, bdy.y
    ux = (np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y)
          - 0.9 * np.sin(3 * x) * np.cos(y))
    uy = (2 * np.exp(np.sin(x)) * np.cos(2 * y)
          - 0.3 * np.cos(3 * x) * np.sin(y))
    return ux * bdy.normal_x + uy * bdy.normal_y


def usol(x, y):
    return np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)


def vsol(x, y):
    return -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)


def fuf(x, y):
    return (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
            - np.sin(x) * np.sin(y))


def fvf(x, y):
    return (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
            + np.cos(x) * np.cos(y))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _plans_as_port(jbie):
    """The port's BIE radial plans on an ipde_tpu BIE."""
    for i, e in enumerate(jbie.ebdyc):
        for j, (src, ej) in enumerate(zip(jbie.src_list, jbie.ebdyc)):
            if not (i == j and e.interior):
                jbie.radial_plans[i][j] = JSRA(src, e.radial_x, e.radial_y,
                                               k_density=ej.bdy.N // 2,
                                               max_stride=1)
    return jbie


def _gap(got, want, phys, shift=False):
    """max |got - want| over the physical grid points and every radial
    grid, relative to max |want| there; ``shift``: less the mean of
    got - want on the physical grid (a pressure)."""
    g, w = _np(got.grid), _np(want.grid)
    c = (g - w)[phys].mean() if shift else 0.0
    scale = max(np.abs(w)[phys].max(),
                max(np.abs(_np(r)).max() for r in want.radials))
    gap = max(np.abs(g - w - c)[phys].max(),
              max(np.abs(_np(a) - _np(b) - c).max()
                  for a, b in zip(got.radials, want.radials)))
    return gap / scale


def _iters_close(st, jst):
    return all(abs(a - int(b)) <= 1 for a, b in
               zip(st["annular_iterations"], jst["annular_iterations"]))


def _port(jc, bh):
    tc = load_collection(jc.save(), "cpu")
    tc.generate_grid(bh)
    return tc


@pytest.fixture(scope="module")
def poisson2():
    """Poisson with one inclusion of the interior boundary's (n, M), solved
    by ipde_tpu with solver_type="fourth" (dense grid backend)."""
    M = 6
    outer = jstar(64, a=0.1, f=3)
    inner = jstar(64, x=0.1, y=-0.05, r=0.35, a=0.05, f=3)
    bh = min(outer.min_h(), inner.min_h(),
             0.6 / np.abs(inner.curvature).max() / M)
    jc = JEBC([JEB(outer, True, M, bh), JEB(inner, False, M, bh)])
    jc.generate_grid(bh)
    js = JPS(jc, grid_backend="dense", solver_type="fourth")
    jf = JEF.from_function(jc, pfrc)
    jraw, jst = js.solve_with_stats(jf, **SOLVE)
    juf = _plans_as_port(JDBIE(js)).apply_bc(jraw, JBF.from_function(jc,
                                                                     psol))
    tc = _port(jc, bh)
    return dict(jraw=jraw, jst=jst, juf=juf, tc=tc,
                tf=EmbeddedFunction.load(jf.save(), "cpu"),
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
    M = 6
    bdy = jstar(64, a=0.1, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-14)])
    jc.generate_grid(bh)
    js = JMHS(jc, k=KH, grid_backend="dense", solver_type="fourth")
    jf = JEF.from_function(jc, mfrc)
    jraw, jst = js.solve_with_stats(jf, **SOLVE)
    bcn = mdn(jc.ebdys[0].bdy)
    juf = _plans_as_port(JNBIE(js)).apply_bc(jraw, JBF([jnp.asarray(bcn)]))
    tc = _port(jc, bh)
    return dict(jraw=jraw, jst=jst, juf=juf, tc=tc,
                tf=EmbeddedFunction.load(jf.save(), "cpu"),
                tbc=BoundaryFunction([torch.as_tensor(bcn)]))


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
    M = 6
    bdy = jstar(64, a=0.1, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-12)])
    jc.generate_grid(bh)
    js = JSS(jc, grid_backend="dense", solver_type="fourth")
    jfu, jfv = JEF.from_function(jc, fuf), JEF.from_function(jc, fvf)
    jraw, jst = js.solve_with_stats(jfu, jfv, **SOLVE)
    juvp = JSBIE(js).apply_bc(*jraw, JBF.from_function(jc, usol),
                              JBF.from_function(jc, vsol))
    tc = _port(jc, bh)
    return dict(jraw=jraw, jst=jst, juvp=juvp, tc=tc,
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
