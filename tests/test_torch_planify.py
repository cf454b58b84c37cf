"""The port's utils/planify.py and its device-resident GMRES against
ipde_tpu.

ipde_tpu's tests/test_planify.py problem, star(96, a=0.1, f=3), M=6,
qfs_tolerance=1e-12, built once in ipde_tpu and carried to the port by
``save`` / ``load_collection``, both on the dense grid backend and the host
setup backend (what ``auto_backend`` picks on the CPU); the stepper's solves
and the card's take the fft backend.  On the CPU
``planified`` runs the solve with the plan tensors installed, as ipde_tpu's
``jit=False`` does; the tests hold it to ipde_tpu's planified solve
(1e-10, as tests/test_planify.py) and to the port's eager solve, ``replan``
to the eager solve of a rebuilt solver (bit for bit) and to ipde_tpu's
errors, ``PlanStore`` to its slots, the lockstep GMRES to ipde_tpu's
``gmres`` (x within 1e-12, iterations equal) and its frozen systems to
themselves, and the planified stepper to the eager one (1e-13, no
recompile).

Marker ``gpu`` (skipped with a reason where torch sees no CUDA device): the
capture of a small Poisson and Stokes solve with no synchronizing call
(``torch.cuda.set_sync_debug_mode("error")``), its replays bit-equal to the
eager solve, ``replan`` on the card, the planified stepper, and each kernel
replayed in a CUDA graph against its plain version."""

import numpy as np
import pytest
import torch

import _torch_testing as tt
from _torch_testing import as_np as _np, cuda_or_skip
from _torch_testing import one_torch_thread  # noqa: F401
from _torch_testing import pfrc as frc, psol as sol
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.ops.gmres import gmres as jgmres
from ipde_tpu.solvers.bie import DirichletBIE as JBIE
from ipde_tpu.solvers.scalar import PoissonSolver as JPS
from ipde_tpu.utils.planify import planified as jplanified
from ipde_tpu.utils.planify import replan as jreplan
from ipde_tpu_torch.advection.stepper import CoupledAdvectionDiffusionStepper
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                load_collection)
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import gmres as G
from ipde_tpu_torch.parallel.sharded import Mesh
from ipde_tpu_torch.solvers import annular_scalar as ann
from ipde_tpu_torch.solvers.bie import DirichletBIE
from ipde_tpu_torch.solvers.scalar import PoissonSolver
from ipde_tpu_torch.utils.planify import PlanStore, planified, replan

NB, M = 96, 6
SOLVE = dict(tol=1e-12)


def _jproblem(nb):
    bdy = jstar(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-12)])
    jc.generate_grid(bh)
    js = JPS(jc, grid_backend="dense")
    return jc, js, JBIE(js), bh


def _port(jc, bh, device="cpu", grid_backend="dense"):
    tc = load_collection(jc.save(), device)
    tc.generate_grid(bh)
    ts = PoissonSolver(tc, grid_backend=grid_backend)
    return tc, ts, DirichletBIE(ts)


def _step(solver, bie, bc):
    """tests/test_planify.py's step: solve + apply_bc, (grid, stats)."""
    def step(fg, frad):
        ue, st = solver.solve_with_stats(EmbeddedFunction(fg, [frad]),
                                         **SOLVE)
        return bie.apply_bc(ue, bc).grid, st
    return step


@pytest.fixture(scope="module")
def problem():
    tt.wait_native()
    jc, js, jb, bh = _jproblem(NB)
    jf, jbc = JEF.from_function(jc, frc), JBF.from_function(jc, sol)
    tc, ts, tb = _port(jc, bh)
    return dict(jc=jc, js=js, jb=jb, jf=jf, jbc=jbc, bh=bh, tc=tc, ts=ts,
                tb=tb, tf=EmbeddedFunction.load(jf.save(), "cpu"),
                tbc=BoundaryFunction.from_function(tc, sol))


# ---------------------------------------------------------------------------
# PlanStore
# ---------------------------------------------------------------------------

def test_plan_store_collects_dedupes_and_restores(problem):
    ts, tb = problem["ts"], problem["tb"]
    store = PlanStore(ts, tb)
    plans = store.snapshot()
    assert store.n_arrays >= 20
    assert len({id(t) for t in plans}) == store.n_arrays
    # the annular solver's static operators are shared with the metric's
    # cached bundle: one plan index under several owners
    occ = store.name_occurrences()
    D01 = ts.helpers[0].annular_solver.ops_static["D01"]
    idx = next(i for i, t in enumerate(plans) if t is D01)
    owners = [k for k, v in occ.items() if idx in v]
    assert len(owners) >= 2 and store.slot_owner(idx) in owners
    stand_ins = [torch.zeros_like(t) for t in plans]
    symbol = next(i for i, t in enumerate(plans) if t is ts._symbol)
    with pytest.raises(RuntimeError, match="inside"):
        with store.installed(stand_ins):
            assert ts._symbol is stand_ins[symbol]
            assert all(a is b for a, b in zip(PlanStore(ts, tb).snapshot(),
                                              stand_ins))
            raise RuntimeError("inside")
    assert ts._symbol is plans[symbol]
    assert all(a is b for a, b in zip(PlanStore(ts, tb).snapshot(), plans))


def test_planified_accepts_a_mesh(problem):
    """A root holding a mesh of two CPU shards: the call runs with the
    plans installed (bit-equal to the eager mesh solve), and replan onto a
    rebuilt solver under the same mesh gives that solver's eager mesh
    solve; replan onto a graph without the mesh raises, and so does a mesh
    that puts a CPU shard beside a card."""
    p = problem
    ts, tb, tf, tbc = p["ts"], p["tb"], p["tf"], p["tbc"]
    mesh = Mesh(["cpu", "cpu"])
    ts.use_mesh(mesh)
    ts2 = PoissonSolver(p["tc"], grid_backend="dense")
    tb2 = DirichletBIE(ts2)
    ts2.use_mesh(mesh)
    try:
        want = tb.apply_bc(ts(tf, **SOLVE), tbc)
        run = planified(_step(ts, tb, tbc), ts, tb)
        assert run.store.meshes == [("PoissonSolver._mesh", mesh.devices)]
        g, _ = run(tf.grid, tf.radials[0])
        assert torch.equal(g, want.grid) and run.captured is None
        f2 = EmbeddedFunction.from_function(
            p["tc"], lambda x, y: 2.0 * frc(x, y) + np.cos(y))
        want2 = tb2.apply_bc(ts2(f2, **SOLVE), tbc)
        assert replan(run, ts2, tb2) is run
        g2, _ = run(f2.grid, f2.radials[0])
        assert torch.equal(g2, want2.grid)
        ts2.use_mesh(None)
        with pytest.raises(ValueError, match="meshes"):
            replan(run, ts2, tb2)
    finally:
        ts.use_mesh(None)
    with pytest.raises(ValueError, match="shard 1 on the CPU"):
        planified(lambda: None, Mesh(["cuda:0", "cpu"]))


# ---------------------------------------------------------------------------
# planified and replan on the CPU
# ---------------------------------------------------------------------------

def test_planified_matches_ipde_tpu_and_eager(problem):
    p = problem
    ts, tb, tf = p["ts"], p["tb"], p["tf"]
    plain = tb.apply_bc(ts(tf, **SOLVE), p["tbc"])
    run = planified(_step(ts, tb, p["tbc"]), ts, tb)
    n = run.store.n_arrays
    assert n > 20 and len(run.plans) == n and run.captured is None
    g, st = run(tf.grid, tf.radials[0])
    # no plan tensor made at first use (it would escape replan)
    assert PlanStore(ts, tb).n_arrays == n
    jrun = jplanified(_step_j(p), p["js"], p["jb"], jit=False)
    jg, jst = jrun(p["jf"].grid, p["jf"].radials[0])
    assert np.abs(_np(g) - np.asarray(jg)).max() < 1e-10
    assert set(st) == set(jst) == {"annular_iterations",
                                   "annular_residuals"}
    assert int(st["annular_iterations"][0]) > 0
    assert float(st["annular_residuals"][0]) < 1e-10
    assert abs(int(st["annular_iterations"][0])
               - int(jst["annular_iterations"][0])) <= 1
    assert ts.iteration_counts == [int(st["annular_iterations"][0])]
    assert torch.equal(g, plain.grid)
    # eager path still works after the call
    again = tb.apply_bc(ts(tf, **SOLVE), p["tbc"])
    assert torch.equal(again.grid, plain.grid)
    # entry()'s form: inner(plans, *args)
    assert torch.equal(run.inner(run.plans, tf.grid, tf.radials[0])[0],
                       plain.grid)


def _step_j(p):
    js, jb, jbc = p["js"], p["jb"], p["jbc"]

    def step(fg, frad):
        ue, st = js.solve_with_stats(JEF(fg, [frad]), tol=1e-12)
        return jb.apply_bc(ue, jbc).grid, st
    return step


def test_replan_reproduces_the_rebuilt_solver(problem):
    p = problem
    tc, ts, tb = p["tc"], p["ts"], p["tb"]
    run = planified(_step(ts, tb, p["tbc"]), ts, tb)
    run(p["tf"].grid, p["tf"].radials[0])
    # the same geometry rebuilt: other objects, the same shapes
    ts2 = PoissonSolver(tc, grid_backend="dense")
    tb2 = DirichletBIE(ts2)
    f2 = EmbeddedFunction.from_function(tc, lambda x, y: 2.0 * frc(x, y)
                                        + np.cos(y))
    want = tb2.apply_bc(ts2(f2, **SOLVE), p["tbc"])
    assert replan(run, ts2, tb2) is run
    assert all(a is b for a, b in zip(run.plans, PlanStore(ts2,
                                                           tb2).snapshot()))
    g, _ = run(f2.grid, f2.radials[0])
    assert torch.equal(g, want.grid)


def test_replan_onto_another_size_raises_as_ipde_tpu(problem):
    p = problem
    jc, js, jb, bh = _jproblem(100)
    _, ts, tb = _port(jc, bh)
    run = planified(_step(p["ts"], p["tb"], p["tbc"]), p["ts"], p["tb"])
    jrun = jplanified(_step_j(p), p["js"], p["jb"], jit=False)
    with pytest.raises(ValueError, match="replan") as got:
        replan(run, ts, tb)
    with pytest.raises(ValueError, match="replan") as jgot:
        jreplan(jrun, js, jb)
    named = "slot " in str(jgot.value)
    assert ("slot " in str(got.value)) == named
    if named:
        owner = str(got.value).split("(")[1].split(")")[0]
        assert "." in owner and owner != "<unknown>"


# ---------------------------------------------------------------------------
# the lockstep GMRES
# ---------------------------------------------------------------------------

def _system(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 3 + scale * rng.standard_normal((n, n)) / np.sqrt(n)
    P = np.linalg.inv(np.diag(np.diag(A)) + np.triu(A, 1) * 0.5)
    return A, P, rng.standard_normal(n)


@pytest.mark.parametrize("restart", [5, 30])
def test_gmres_matches_ipde_tpu(restart):
    """Iterations equal: each cycle of either stops at the same Arnoldi
    estimate, and the true residual at each cycle end is below tol once the
    estimate is (no extra cycle on this system)."""
    import jax.numpy as jnp
    A, P, b = _system(60, 17, scale=2.0)
    At, Pt = torch.as_tensor(A), torch.as_tensor(P)
    res = G.gmres(lambda v: At @ v, torch.as_tensor(b),
                  precond=lambda v: Pt @ v, tol=1e-13, maxiter=120,
                  restart=restart)
    jr = jgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                precond=lambda v: jnp.asarray(P) @ v, tol=1e-13,
                maxiter=120, restart=restart)
    jx = np.asarray(jr.x)
    assert np.abs(_np(res.x) - jx).max() <= 1e-12 * np.abs(jx).max()
    assert int(res.iterations) == int(jr.iterations)
    assert int(res.iterations) > restart or restart == 30
    assert float(res.residual) <= 1e-13
    assert res.x.device.type == res.iterations.device.type == "cpu"


def test_batched_frozen_rows_stay_and_maxiter_raises(problem, monkeypatch):
    """Three systems that converge at different steps: once a system's true
    residual has met tol at a cycle end its row of x never changes again,
    and it is fed zero rows from the step its estimate met tol."""
    systems = [_system(40, s, scale) for s, scale in ((1, 0.2), (2, 1.0),
                                                      (3, 2.5))]
    A = torch.as_tensor(np.stack([s[0] for s in systems]))
    P = torch.as_tensor(np.stack([s[1] for s in systems]))
    b = torch.as_tensor(np.stack([s[2] for s in systems]))
    fed = []

    def precond(v):
        fed.append(v.abs().amax(dim=1) > 0)
        return (P @ v[..., None])[..., 0]

    xs = []
    end = G.LockstepGmres.end

    def spy_end(self):
        end(self)
        xs.append((self.x.clone(), self.run_.clone()))
    monkeypatch.setattr(G.LockstepGmres, "end", spy_end)
    res = G.batched_gmres(lambda v: (A @ v[..., None])[..., 0], b, precond,
                          tol=1e-13, maxiter=60, restart=6)
    its = [int(i) for i in res.iterations]
    assert len(set(its)) == 3 and max(res.residual) <= 1e-13
    for i in range(3):
        frozen = [k for k, (_, run) in enumerate(xs) if not run[i]]
        assert frozen, i
        for k in frozen[1:]:
            assert torch.equal(xs[k][0][i], xs[frozen[0]][0][i])
    # the fastest system is fed its own rows for exactly its iterations
    # (the Arnoldi steps) plus one per cycle end (the x update)
    fast = int(np.argmin(its))
    n_fed = sum(bool(f[fast]) for f in fed)
    cycles = -(-its[fast] // 6)
    assert n_fed == its[fast] + cycles
    monkeypatch.undo()
    h = problem["ts"].helpers[0]
    rhs = h.annular_rhs(torch.ones(h.annular_solver.M, h.annular_solver.n,
                                   dtype=torch.float64))
    with pytest.raises(RuntimeError, match="did not converge"):
        ann.batched_annular_solve([h.annular_solver], [h.metric], [rhs],
                                  tol=1e-12, maxiter=2, restart=2)


# ---------------------------------------------------------------------------
# the stepper
# ---------------------------------------------------------------------------

SNB, SM, SPQ = 48, 8, 256
NU, DT, T0 = 0.05, 0.05, 0.5


def _stepper_collection(device="cpu"):
    bdy = star(SNB, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / SM)
    c = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, SM, bh, qfs_tolerance=1e-12)],
        device=device)
    c.generate_grid(bh, pad_quantum=SPQ)
    return c


def _c0(x, y):
    s = 4 * NU * T0
    return np.exp(-(x * x + y * y) / s) / (np.pi * s)


def _velocity(ebdyc):
    return (EmbeddedFunction.from_function(ebdyc, lambda x, y: -y),
            EmbeddedFunction.from_function(ebdyc, lambda x, y: x))


def _two_steps(device, planify):
    ebdyc = _stepper_collection(device)
    stepper = CoupledAdvectionDiffusionStepper(ebdyc, _velocity, NU, DT,
                                               planify=planify)
    c = EmbeddedFunction.from_function(ebdyc, _c0)
    for _ in range(2):
        c = stepper.step(c)
    return stepper, c


def _field_gap(a, b):
    scale = max(float(b.grid.abs().max()),
                *(float(r.abs().max()) for r in b.radials))
    gap = max(float((x - y).abs().max())
              for x, y in zip((a.grid, *a.radials), (b.grid, *b.radials)))
    return gap / scale


def test_planified_stepper_matches_eager():
    eager, ce = _two_steps("cpu", False)
    plan, cp = _two_steps("cpu", True)
    assert plan._jsolve is not None and eager._jsolve is None
    assert plan.recompiles == 0 and plan.miss_log == []
    assert set(plan.last_times) == {"generate_s", "advect_s", "setup_s",
                                    "solve_s"}
    assert _field_gap(cp, ce) <= 1e-13


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _stokes_problem(device):
    from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
    from ipde_tpu_torch.solvers.vector import StokesSolver
    bdy = star(128, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / 8)
    c = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, 8, bh, qfs_tolerance=1e-12)],
        device=device)
    c.generate_grid(bh)
    s = StokesSolver(c)
    b = StokesDirichletBIE(s)
    fu = EmbeddedFunction.from_function(c, lambda x, y: np.sin(x) * np.cos(y))
    fv = EmbeddedFunction.from_function(c, lambda x, y: np.cos(x) * np.sin(y))
    bu = BoundaryFunction.from_function(c, lambda x, y: np.cos(2 * y))
    bv = BoundaryFunction.from_function(c, lambda x, y: np.sin(2 * x))

    def fn(fug, fur, fvg, fvr):
        (u, v, p), st = s.solve_with_stats(EmbeddedFunction(fug, [fur]),
                                           EmbeddedFunction(fvg, [fvr]),
                                           **SOLVE)
        out = b.apply_bc(u, v, p, bu, bv)
        return [t for ef in out for t in (ef.grid, *ef.radials)], st
    return s, b, fn, (fu.grid, fu.radials[0], fv.grid, fv.radials[0])


def _poisson_card(problem):
    _, ts, tb = _port(problem["jc"], problem["bh"], "cuda", "fft")
    tf = EmbeddedFunction.load(problem["jf"].save(), "cuda")
    bc = BoundaryFunction.from_function(ts.ebdyc, sol)

    def fn(fg, fr):
        g, st = _step(ts, tb, bc)(fg, fr)
        return [g], st
    return ts, tb, fn, (tf.grid, tf.radials[0])


@pytest.mark.gpu
@pytest.mark.parametrize("pde", ["poisson", "stokes"])
def test_capture_has_no_sync_and_replays_bit_equal(problem, pde):
    cuda_or_skip()
    s, b, fn, args = (_poisson_card(problem) if pde == "poisson"
                      else _stokes_problem("cuda"))
    want, wst = fn(*args)                  # warm: first-use work done here
    run = planified(fn, s, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args)
        got, st = run(*args)
        again, _ = run(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert run.captured is not None and run.captured.recorder.steps
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    assert [int(i) for i in st["annular_iterations"]] == \
        [int(i) for i in wst["annular_iterations"]]


@pytest.mark.gpu
def test_replan_on_the_card(problem):
    cuda_or_skip()
    s, b, fn, args = _poisson_card(problem)
    run = planified(fn, s, b)
    run(*args)
    ts2 = PoissonSolver(s.ebdyc)
    tb2 = DirichletBIE(ts2)
    bc = BoundaryFunction.from_function(s.ebdyc, sol)
    f2 = EmbeddedFunction.from_function(
        s.ebdyc, lambda x, y: 2.0 * frc(x, y) + np.cos(y))
    want = tb2.apply_bc(ts2(f2, **SOLVE), bc)
    steps = run.captured.recorder.steps
    replan(run, ts2, tb2)
    got, _ = run(f2.grid, f2.radials[0])
    assert run.captured.recorder.steps is steps
    assert torch.equal(got[0], want.grid)


@pytest.mark.gpu
def test_planified_stepper_on_the_card():
    cuda_or_skip()
    eager, ce = _two_steps("cuda", False)
    plan, cp = _two_steps("cuda", True)
    assert plan.recompiles == 0
    assert _field_gap(cp, ce) <= 1e-13


@pytest.mark.gpu
def test_kernels_replayed_in_a_graph():
    cuda_or_skip()
    from ipde_tpu_torch.ops import kernels as K
    from ipde_tpu_torch.ops import stokes_kernels as SK
    rng = np.random.default_rng(4)
    S, T = 600, 5000
    d = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    sx, sy, q, q2 = (d(rng.standard_normal(S)) for _ in range(4))
    tx, ty = d(rng.uniform(-3, 3, T)), d(rng.uniform(-3, 3, T))
    cases = ((K.laplace_slp_apply, K.laplace_slp_apply_plain,
              (sx, sy, q, tx, ty)),
             (K.laplace_slp_grad_apply, K.laplace_slp_grad_apply_plain,
              (sx, sy, q, tx, ty)),
             (K.mh_slp_apply, K.mh_slp_apply_plain, (sx, sy, q, tx, ty, 2.0)),
             (SK.stokes_slp_apply, SK.stokes_slp_apply_plain,
              (sx, sy, q, q2, tx, ty)))
    for kernel, plain, args in cases:
        kernel(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(*args)
        graph.replay()
        want = plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        for o, w in zip(outs, wants):
            scale = float(w.abs().max())
            assert float((o - w).abs().max()) <= 1e-12 * max(scale, 1.0)
