"""Planified solves under ``use_mesh`` (``ipde_tpu_torch/utils/planify.py``
over ``parallel/sharded.py``) against ``ipde_tpu``'s and against the port's
own eager mesh solves.

The two-body Poisson problem of ``dryrun_multichip`` at nb = 64, M = 6
(``__graft_entry__._build_problem``'s geometry: star(64, a=0.1, f=3) and an
inclusion star(64, r=0.22, a=0.05, f=4)), on meshes of CPU shards
(``[cpu] * 4``).  On the CPU a planified call runs the solve with the plan
tensors installed, as ``ipde_tpu``'s ``jit=False`` does:

- (a) the port's planified solve + apply_bc within 1e-10 of ``ipde_tpu``'s
  planified (jitted) solve under a 4-device JAX mesh (conftest's virtual
  CPU devices; ``ipde_tpu`` on its dense grid backend, its BIE given the
  port's radial plans, see tests/test_torch_sharded.py), and bit-equal to
  the port's eager mesh solve;
- (b) ``replan`` onto the problem rebuilt with its inclusion turned by
  0.01 (every plan shape equal, the values and the answer not) gives the
  rebuilt solver's eager mesh solve bit for bit; ``replan`` onto nb = 72
  raises ValueError as ``ipde_tpu``'s does on the same pair;
- (c) Stokes and Yukawa k = 2 (Dirichlet) on the two-body collection,
  planified under the mesh, bit-equal to their eager mesh solves.

Marker ``gpu`` (skipped with a reason where torch sees no CUDA device):
(d) capture and replays with 4 shards on one card, bit-equal to the eager
mesh solve, no synchronizing call during the capture
(``torch.cuda.set_sync_debug_mode("error")``), the replays launching the
Laplace kernel; (e) ``replan`` on the card onto the turned inclusion (what
a capture reading the first solver's boundary groups or source mirrors
would get wrong); (f) a mesh of the card and the CPU raises ValueError;
(g) a capture across two cards (skipped where torch sees fewer)."""

import numpy as np
import pytest
import torch

from _torch_testing import SOLVE, as_np as _np, plans_as_port
from _torch_testing import cards_or_skip as _cards
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.parallel import sharded as jsh
from ipde_tpu.solvers.bie import DirichletBIE as JDBIE
from ipde_tpu.solvers.scalar import PoissonSolver as JPS
from ipde_tpu.utils.planify import planified as jplanified
from ipde_tpu.utils.planify import replan as jreplan
from ipde_tpu_torch.entry import frc, sol
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                load_collection)
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels as tk
from ipde_tpu_torch.parallel.sharded import Mesh, make_mesh
from ipde_tpu_torch.solvers.bie import DirichletBIE, StokesDirichletBIE
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver
from ipde_tpu_torch.utils.planify import launch_book, planified, replan

NB, M = 64, 6
CPU4 = ["cpu"] * 4
TURN = 0.01          # the rebuilt problem's inclusion, turned


def _curves(star_fn, nb, rot=0.0):
    bdy = star_fn(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    return bdy, star_fn(nb, x=0.0, y=0.0, r=0.22, a=0.05, f=4, rot=rot), bh


def _jproblem(nb):
    """ipde_tpu's two-body problem on its dense grid backend, the BIE with
    the port's radial plans: (collection, solver, BIE, h)."""
    bdy, inc, bh = _curves(jstar, nb)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-12),
               JEB(inc, False, M, bh, qfs_tolerance=1e-12)])
    jc.generate_grid(bh)
    js = JPS(jc, grid_backend="dense")
    return jc, js, plans_as_port(JDBIE(js)), bh


def _collection(rot=0.0, nb=NB, device="cpu"):
    """The port's two-body collection, its inclusion turned by ``rot``."""
    bdy, inc, bh = _curves(star, nb, rot)
    c = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12),
         EmbeddedBoundary(inc, False, M, bh, qfs_tolerance=1e-12)],
        device=device)
    c.generate_grid(bh)
    return c


def _poisson(c, mesh):
    """(solver, BIE, boundary data, forcing args) of the Poisson problem on
    ``c``, the solver under ``mesh``."""
    s = PoissonSolver(c)
    s.use_mesh(mesh)
    f = EmbeddedFunction.from_function(c, frc)
    return s, DirichletBIE(s), BoundaryFunction.from_function(c, sol), \
        (f.grid, *f.radials)


def _step(s, b, bc):
    """solve + apply_bc of the forcing (grid, *radials) -> [grid,
    *radials]."""
    def step(fg, *fr):
        ue = b.apply_bc(s(EmbeddedFunction(fg, list(fr)), **SOLVE), bc)
        return [ue.grid, *ue.radials]
    return step


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def reference():
    """ipde_tpu's planified two-body solve under a 4-device JAX mesh, and
    the port's problem on the same saved collection."""
    jc, js, jb, bh = _jproblem(NB)
    jf, jbc = JEF.from_function(jc, frc), JBF.from_function(jc, sol)
    js.use_mesh(jsh.make_mesh(4))

    def jstep(fg, *fr):
        ue = jb.apply_bc(js(JEF(fg, list(fr)), **SOLVE), jbc)
        return [ue.grid, *ue.radials]

    jrun = jplanified(jstep, js, jb)
    jout = [np.asarray(a) for a in jrun(jf.grid, *jf.radials)]
    tc = load_collection(jc.save(), "cpu")
    tc.generate_grid(bh)
    return dict(jrun=jrun, jout=jout,
                port=_poisson(tc, make_mesh(devices=CPU4)))


@pytest.fixture(scope="module")
def turned():
    """The port's two-body problem and its rebuild with the inclusion
    turned, both under one [cpu] * 4 mesh."""
    mesh = make_mesh(devices=CPU4)
    return mesh, _poisson(_collection(), mesh), \
        _poisson(_collection(TURN), mesh)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def test_planified_mesh_solve_matches_ipde_tpu_and_eager(reference):
    s, b, bc, args = reference["port"]
    step = _step(s, b, bc)
    want = step(*args)
    run = planified(step, s, b)
    assert [n for n, _ in run.store.meshes] == ["PoissonSolver._mesh"]
    got = run(*args)
    assert run.captured is None and _equal(got, want)
    assert max(np.abs(_np(g) - j).max()
               for g, j in zip(got, reference["jout"])) <= 1e-10
    assert s._mesh.boundary_groups is not None      # the split lockstep


def test_replan_under_the_mesh_reproduces_the_rebuilt_solver(turned):
    _, (s, b, bc, args), (s2, b2, bc2, args2) = turned
    run = planified(_step(s, b, bc), s, b, bc)
    first = run(*args)
    want = _step(s2, b2, bc2)(*args2)
    assert not _equal(first, want)
    assert replan(run, s2, b2, bc2) is run
    assert _equal(run(*args2), want)


def test_replan_under_the_mesh_onto_another_size_raises_as_ipde_tpu(
        reference, turned):
    mesh, (s, b, bc, _), _ = turned
    s72, b72, bc72, _ = _poisson(_collection(nb=72), mesh)
    run = planified(_step(s, b, bc), s, b, bc)
    _, js, jb, _ = _jproblem(72)
    js.use_mesh(jsh.make_mesh(4))
    with pytest.raises(ValueError, match="replan") as got:
        replan(run, s72, b72, bc72)
    with pytest.raises(ValueError, match="replan") as jgot:
        jreplan(reference["jrun"], js, jb)
    assert ("slot " in str(got.value)) == ("slot " in str(jgot.value))


def _stokes_fn(c, mesh):
    s = StokesSolver(c, grid_backend="dense")
    s.use_mesh(mesh)
    b = StokesDirichletBIE(s)
    fu = EmbeddedFunction.from_function(c, lambda x, y: np.sin(x) * np.cos(y))
    fv = EmbeddedFunction.from_function(c, lambda x, y: np.cos(x) * np.sin(y))
    bcs = [BoundaryFunction.from_function(c, lambda x, y: np.sin(x + y))] * 2
    n = len(fu.radials)

    def fn(*a):
        u, v, p = s(EmbeddedFunction(a[0], list(a[1:1 + n])),
                    EmbeddedFunction(a[1 + n], list(a[2 + n:])), **SOLVE)
        return [t for ef in b.apply_bc(u, v, p, *bcs)
                for t in (ef.grid, *ef.radials)]
    return s, b, fn, (fu.grid, *fu.radials, fv.grid, *fv.radials)


def _yukawa_fn(c, mesh):
    s = ModifiedHelmholtzSolver(c, k=2.0, grid_backend="dense")
    s.use_mesh(mesh)
    b = DirichletBIE(s)
    f = EmbeddedFunction.from_function(c, lambda x, y: np.sin(x) * np.cos(y))
    bc = BoundaryFunction.from_function(c, lambda x, y: np.cos(x + y))
    return s, b, _step(s, b, bc), (f.grid, *f.radials)


@pytest.mark.parametrize("pde", ["stokes", "yukawa"])
def test_stokes_and_yukawa_planified_under_the_mesh(pde, turned):
    mesh, (poisson, *_), _ = turned
    s, b, fn, args = (_stokes_fn if pde == "stokes" else _yukawa_fn)(
        poisson.ebdyc, mesh)
    want = fn(*args)
    run = planified(fn, s, b)
    assert run.store.meshes and _equal(run(*args), want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_mesh(cards, n=4):
    return make_mesh(devices=[cards[i % len(cards)] for i in range(n)])


def _capture_and_hold(mesh):
    """Capture the two-body solve under ``mesh`` with no synchronizing call
    and hold two replays to the eager mesh solve, bit for bit; returns the
    planified call."""
    s, b, bc, args = _poisson(_collection(device=mesh.lead), mesh)
    step = _step(s, b, bc)
    want = step(*args)                 # warm: first-use work done here
    run = planified(step, s, b, bc)
    replayed = launch_book()["laplace_slp_apply"][1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, again = run(*args), run(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert run.captured is not None
    assert any(st[0] == "loop" for st in run.captured.recorder.steps)
    assert _equal(got, want) and _equal(again, want)
    assert launch_book()["laplace_slp_apply"][1] > replayed
    return run


@pytest.mark.gpu
def test_capture_under_the_mesh_on_one_card():
    cards = _cards()
    run = _capture_and_hold(_card_mesh(cards[:1]))
    assert list(run.captured.pool_bytes_by_card) == [str(cards[0])]


@pytest.mark.gpu
def test_replan_under_the_mesh_on_the_card():
    cards = _cards()
    mesh = _card_mesh(cards[:1])
    s, b, bc, args = _poisson(_collection(device=cards[0]), mesh)
    s2, b2, bc2, args2 = _poisson(_collection(TURN, device=cards[0]), mesh)
    run = planified(_step(s, b, bc), s, b, bc)
    run(*args)
    steps = run.captured.recorder.steps
    want = _step(s2, b2, bc2)(*args2)
    replan(run, s2, b2, bc2)
    got = run(*args2)
    assert run.captured.recorder.steps is steps
    assert _equal(got, want)


@pytest.mark.gpu
def test_card_and_cpu_mesh_raises():
    cards = _cards()
    c = _collection(device=cards[0])
    s, b, bc, _ = _poisson(c, Mesh([cards[0], "cpu", cards[0], "cpu"]))
    before = tk.laplace_slp_apply.launches
    with pytest.raises(ValueError, match="shard 1, .*shard 3 on the CPU"):
        planified(_step(s, b, bc), s, b, bc)
    assert tk.laplace_slp_apply.launches == before


@pytest.mark.gpu
def test_capture_across_two_cards():
    cards = _cards()
    if len(cards) < 2:
        pytest.skip(f"needs two CUDA devices, torch sees {len(cards)}")
    run = _capture_and_hold(_card_mesh(cards[:2]))
    assert sorted(run.captured.pool_bytes_by_card) == \
        sorted(map(str, cards[:2]))
