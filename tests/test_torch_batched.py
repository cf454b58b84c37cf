"""The port's batched annular solves and helper reuse against ipde_tpu: a
Poisson problem with one inclusion of the interior boundary's (M, n) (both
packages take the batched annular GMRES; ipde_tpu on the dense grid
backend, the port on the fft one) with DirichletBIE; ``batched_annular_solve``
against ipde_tpu's and against the per-boundary solves; ``batched_gmres``
against ``gmres``; the ``helpers=`` reuse of tests/test_helper_reuse.py on the
port.  Both packages are built from one saved geometry, at small sizes
(M = 6).  Marker ``gpu``: the Poisson solve on the card against the CPU,
skipped with a reason where torch sees no CUDA device.

The reference BIE is given the port's radial plans (every source except on
an interior boundary's own rows; see tests/test_torch_multi_body.py).

Tolerances: solutions to 1e-10 of max |ipde_tpu| (GMRES stops at 1e-12 and
the sums run in another order), GMRES iterations within one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np, mms_err, pfrc, psol
from _torch_testing import cuda_or_skip as _cuda
from _torch_testing import one_torch_thread  # noqa: F401
from _torch_testing import rel_gap as _gap
from ipde_tpu.solvers import annular_scalar as jann
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                load_collection)
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops.gmres import batched_gmres, gmres
from ipde_tpu_torch.solvers import annular_scalar as ann
from ipde_tpu_torch.solvers import scalar as tscalar
from ipde_tpu_torch.solvers.bie import DirichletBIE
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

@pytest.fixture(scope="module")
def poisson2():
    """Poisson with one inclusion of the interior boundary's (n, M): both
    packages take the batched annular GMRES.  ipde_tpu on the dense grid
    backend, the port on the fft one."""
    bodies, bh = tt.two_body()
    jc, tc = tt.paired_collections(bodies, bh)
    ref = tt.reference_solve(bodies, bh, "poisson", (pfrc,), (psol,),
                             port_plans=True)
    return dict(jc=jc, js=ref["js"], jraw=ref["jraw"], jst=ref["jst"],
                juf=ref["jue"], tc=tc, ts=PoissonSolver(tc),
                tf=EmbeddedFunction.load(ref["jf"][0].save(), "cpu"),
                tbc=BoundaryFunction.from_function(tc, psol))


def test_inclusion_poisson_batched(poisson2, monkeypatch):
    p = poisson2
    ts, tc = p["ts"], p["tc"]
    assert ts.grid_backend == "fft"
    calls = []
    orig = tscalar.batched_annular_solve
    monkeypatch.setattr(tscalar, "batched_annular_solve",
                        lambda *a: calls.append(1) or orig(*a))
    raw, st = ts.solve_with_stats(p["tf"], **SOLVE)
    assert calls == [1]
    assert max(st["annular_residuals"]) <= SOLVE["tol"]
    for a, b in zip(st["annular_iterations"], p["jst"]["annular_iterations"]):
        assert abs(a - int(b)) <= 1
    assert _gap(raw, p["jraw"], tc.phys) <= 1e-10
    got = DirichletBIE(ts).apply_bc(raw, p["tbc"])
    assert _gap(got, p["juf"], tc.phys) <= 1e-10
    assert (mms_err(tc, got, psol)
            <= 1.01 * mms_err(tc, p["juf"], psol) + 1e-12)


def test_batched_annular_solve_matches_reference(poisson2):
    jh, th = poisson2["js"].helpers, poisson2["ts"].helpers
    M, n = th[0].annular_solver.M, th[0].annular_solver.n
    rng = np.random.default_rng(31)
    fs = rng.standard_normal((2, M, n))
    jr = [h.annular_rhs(jnp.asarray(f)) for h, f in zip(jh, fs)]
    tr = [h.annular_rhs(torch.as_tensor(f)) for h, f in zip(th, fs)]
    want, jst = jann.batched_annular_solve(
        [h.annular_solver for h in jh], [h.metric for h in jh], jr,
        SOLVE["tol"], SOLVE["maxiter"], SOLVE["restart"])
    got, st = ann.batched_annular_solve(
        [h.annular_solver for h in th], [h.metric for h in th], tr,
        **SOLVE)
    for g, w, it, jit, r, h, f in zip(got, want, st["iterations"],
                                      jst["iterations"], st["residual"], th,
                                      fs):
        assert r <= SOLVE["tol"] and abs(it - int(jit)) <= 1
        w = np.asarray(w)
        assert np.abs(_np(g) - w).max() <= 1e-10 * np.abs(w).max()
        # and against the port's own one-boundary solve
        one, ost = h.annular_solver.solve_with_stats(
            h.metric, torch.as_tensor(f), h.zero_bc, h.zero_bc, **SOLVE)
        assert abs(ost["iterations"] - it) <= 1
        assert np.abs(_np(g) - _np(one)).max() <= 1e-10 * np.abs(w).max()
    with pytest.raises(RuntimeError, match="did not converge"):
        ann.batched_annular_solve([h.annular_solver for h in th],
                                  [h.metric for h in th], tr, tol=1e-12,
                                  maxiter=2, restart=2)


def _systems(n=40, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for scale in (0.3, 1.0, 3.0):       # three rates of convergence
        A = np.eye(n) * 4 + scale * rng.standard_normal((n, n)) / np.sqrt(n)
        P = np.linalg.inv(np.diag(np.diag(A)) + np.triu(A, 1) * 0.5)
        out.append((A, P, rng.standard_normal(n)))
    return out


@pytest.mark.parametrize("restart", [7, 40])
def test_batched_gmres_matches_gmres(restart):
    systems = _systems()
    A = torch.as_tensor(np.stack([s[0] for s in systems]))
    P = torch.as_tensor(np.stack([s[1] for s in systems]))
    b = torch.as_tensor(np.stack([s[2] for s in systems]))
    b[1] = 0.0                        # a zero right-hand side: no iteration
    kw = dict(tol=1e-13, maxiter=80, restart=restart)
    res = batched_gmres(lambda v: (A @ v[..., None])[..., 0], b,
                        precond=lambda v: (P @ v[..., None])[..., 0], **kw)
    assert res.iterations[1] == 0 and res.residual[1] == 0.0
    assert float(res.x[1].abs().max()) == 0.0
    assert res.iterations[0] != res.iterations[2]
    for i in (0, 2):
        one = gmres(lambda v: A[i] @ v, b[i], precond=lambda v: P[i] @ v,
                    **kw)
        assert res.iterations[i] == one.iterations
        assert res.residual[i] <= 1e-13
        true = float(torch.linalg.vector_norm(b[i] - A[i] @ res.x[i])
                     / torch.linalg.vector_norm(b[i]))
        assert res.residual[i] == pytest.approx(true, rel=0, abs=1e-15)
        assert float((res.x[i] - one.x).abs().max()) <= \
            1e-12 * float(one.x.abs().max())


def _moved(a, bh, nb=48, M=6, Mr=None):
    bdy = star(nb, a=a, f=5)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, Mr or M, bh, qfs_tolerance=1e-14)],
        device="cpu")
    ebdyc.generate_grid(bh)
    return ebdyc


def test_scalar_helper_reuse():
    """tests/test_helper_reuse.py::test_scalar_helper_reuse on the port at
    nb=48, M=6, dense grid backend."""
    nb, M, k = 48, 6, 2.0
    b0 = star(nb, a=0.2, f=5)
    bh = min(b0.min_h(), 0.6 / np.abs(b0.curvature).max() / M)
    c0, c1 = _moved(0.2, bh), _moved(0.205, bh)
    dense = dict(grid_backend="dense")
    s0 = ModifiedHelmholtzSolver(c0, k=k, **dense)
    s1 = ModifiedHelmholtzSolver(c1, k=k, helpers=s0.helpers, **dense)
    assert s1.helpers[0].annular_solver is s0.helpers[0].annular_solver
    # another k, or another PDE, must not reuse
    s2 = ModifiedHelmholtzSolver(c1, k=3.0, helpers=s0.helpers, **dense)
    assert s2.helpers[0].annular_solver is not s0.helpers[0].annular_solver
    s3 = PoissonSolver(c1, helpers=s0.helpers, **dense)
    assert s3.helpers[0].annular_solver is not s0.helpers[0].annular_solver
    # the reused preconditioner still reaches discretization accuracy
    u = lambda x, y: np.exp(np.sin(x)) * np.sin(2 * y)  # noqa: E731
    frc = lambda x, y: ((k**2 + 4) * u(x, y)  # noqa: E731
                        - (np.cos(x) ** 2 - np.sin(x)) * u(x, y))
    f = EmbeddedFunction.from_function(c1, frc)
    bc = BoundaryFunction.from_function(c1, u)
    ue = DirichletBIE(s1).apply_bc(s1(f, **SOLVE), bc)
    fresh = ModifiedHelmholtzSolver(c1, k=k, **dense)
    uf = DirichletBIE(fresh).apply_bc(fresh(f, **SOLVE), bc)
    ge = np.abs(_np(ue.grid) - u(c1.grid.xg, c1.grid.yg))[c1.phys].max()
    gf = np.abs(_np(uf.grid) - u(c1.grid.xg, c1.grid.yg))[c1.phys].max()
    assert ge < max(3 * gf, 1e-9), (ge, gf)


def test_stokes_helper_reuse_donor():
    """tests/test_helper_reuse.py::test_stokes_helper_reuse_donor on the
    port at nb=48, M=6."""
    nb, M = 48, 6
    b0 = star(nb, a=0.2, f=5)
    bh = min(b0.min_h(), 0.6 / np.abs(b0.curvature).max() / M)
    c0, c1 = _moved(0.2, bh), _moved(0.205, bh)
    s0 = StokesSolver(c0, grid_backend="dense")
    s1 = StokesSolver(c1, grid_backend="dense", helpers=s0.helpers)
    assert s1.helpers[0].annular_solver is s0.helpers[0].annular_solver
    s2 = StokesSolver(_moved(0.2, bh, Mr=M + 2), grid_backend="dense",
                      helpers=s0.helpers)
    assert s2.helpers[0].annular_solver is not s0.helpers[0].annular_solver


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_inclusion_poisson_on_cuda_matches_cpu(poisson2, monkeypatch):
    # both runs on the host setup backend (the CPU's; the card's default,
    # the device one, is held to the CPU in test_torch_device_setup.py)
    monkeypatch.setenv("IPDE_QFS_BACKEND", "host")
    from ipde_tpu_torch.ops import kernels as K
    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        tc = load_collection(poisson2["jc"].save(), d)
        tc.generate_grid(tc.ebdys[0].h)
        ts = PoissonSolver(tc)
        before = K.laplace_slp_apply.launches
        ue = DirichletBIE(ts).apply_bc(
            ts(EmbeddedFunction.from_function(tc, pfrc), **SOLVE),
            BoundaryFunction.from_function(tc, psol))
        out[str(d)] = (ue, K.laplace_slp_apply.launches - before, tc.phys)
    (cpu, nc, phys), (gpu, ng, _) = out["cpu"], out["cuda:0"]
    assert nc == 0 and ng > 0
    assert _gap(gpu, cpu, phys) <= 1e-10
