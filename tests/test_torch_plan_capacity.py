"""Step-invariant plan capacities of a ``pad_quantum`` registration: a turned
boundary rebuilds its solver and BIE with plan tensors of the set-up
geometry's shapes, so that ``replan`` holds (utils/planify.py).

Problem: star(64, a=0.1, f=3), M = 4, registered with pad_quantum 256,
turned by +0.05 and -0.05 rad on the set-up grid, as the benchmark's moving
mix and the stepper turn it; the Poisson solve (``PoissonSolver`` +
``DirichletBIE``) and the Stokes solve (``StokesSolver`` +
``StokesDirichletBIE``), both on the fft grid backend, on the CPU.  The
tests hold: the plan specs of the turned problems to the set-up's, with no
``plan.capacity_overflow``; the replanned solve to the eager solve of the
turned problem (1e-12); each padded evaluator to an evaluator of the same
sources at its exact shapes (the near corrections, a CSR product and a
gather, bit for bit; the whole apply to 1e-14); a set forced past its
capacity to the counter and a ``replan`` that raises; and an unpadded
registration to the exact shapes it had before capacities existed.  The
in-annulus point sets keep ipde_tpu's layout, padded to the quantum, which
these turns stay inside."""

import numpy as np
import pytest
import torch

from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import grid_eval as tge
from ipde_tpu_torch.solvers.bie import DirichletBIE, StokesDirichletBIE
from ipde_tpu_torch.solvers.scalar import PoissonSolver
from ipde_tpu_torch.solvers.vector import StokesSolver
from ipde_tpu_torch.utils.planify import (PlanStore, _spec, planified,
                                          replan)
from ipde_tpu_torch.utils.profiling import recording, take

NB, M, QUANTUM = 64, 4, 256
TURNS = (0.05, -0.05)
SOLVE = dict(tol=1e-12)
SOLVERS = {"laplace": (PoissonSolver, DirichletBIE),
           "stokes": (StokesSolver, StokesDirichletBIE)}
# (_patch_pieces, _patch_rows, spread_shape) of the solver's and the BIE's
# evaluators of this problem registered without pad_quantum, as they were
# before capacities existed
EXACT = {"laplace": ((8192, 192), (4096, 2), (64, 64)),
         "stokes": ((28672, 384), (12288, 4), (64, 64))}


def _h():
    bdy = star(NB, a=0.1, f=3)
    return min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)


def _collection(rot=0.0, base=None, pad_quantum=QUANTUM):
    """The boundary turned by ``rot``, registered on ``base``'s grid (a new
    grid without ``base``)."""
    c = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(star(NB, a=0.1, f=3, rot=rot), True, M, _h(),
                          qfs_tolerance=1e-12)], device="cpu")
    if base is None:
        c.generate_grid(_h(), pad_quantum=pad_quantum)
    else:
        c.register_grid(base.grid, pad_quantum=pad_quantum)
        c.bump_location = base.bump_location
    return c


def _forcing(c, kind):
    fs = [EmbeddedFunction.from_function(c, lambda x, y: np.sin(x + y)),
          EmbeddedFunction.from_function(c, lambda x, y: np.cos(x) * y)]
    bcs = [BoundaryFunction.from_function(c, lambda x, y: np.cos(2 * y)),
           BoundaryFunction.from_function(c, lambda x, y: np.sin(x))]
    n = 1 if kind == "laplace" else 2
    return fs[:n], bcs[:n]


def _step(solver, bie, n):
    """Solve + apply_bc of ``n`` forcing components and as many boundary
    data, all arguments of the step (perfbench/harness/planstep.py's
    form): a grid and a radial each, then the boundary values."""
    def step(*a):
        fs = [EmbeddedFunction(a[2 * i], [a[2 * i + 1]]) for i in range(n)]
        bcs = [BoundaryFunction([v]) for v in a[2 * n:]]
        out, _ = solver.solve_with_stats(*fs, **SOLVE)
        out = bie.apply_bc(*(out if isinstance(out, tuple) else (out,)),
                           *bcs)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [t for ef in out for t in (ef.grid, *ef.radials)]
    return step


def _args(c, kind):
    fs, bcs = _forcing(c, kind)
    return ([t for f in fs for t in (f.grid, f.radials[0])]
            + [bc.values[0] for bc in bcs])


@pytest.fixture(scope="module")
def problems():
    """kind -> the set-up problem and the turned ones: (collection, solver,
    BIE, plan specs) each, and the counts recorded while they were built."""
    take()
    with recording():
        cols = [_collection()]
        cols += [_collection(r, cols[0]) for r in TURNS]
        out = {}
        for kind, (S, B) in SOLVERS.items():
            built = []
            for c in cols:
                s = S(c)
                b = B(s)
                built.append((c, s, b, [_spec(t) for t in
                                        PlanStore(s, b).snapshot()]))
            out[kind] = built
    return out, take().counts


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_turned_boundaries_keep_the_plan_specs(problems, kind):
    built, counts = problems
    (_, s0, b0, spec0), *turned = built[kind]
    assert counts.get("plan.capacity_overflow", 0) == 0
    run = planified(lambda *a: None, s0, b0)
    for _, s, b, spec in turned:
        assert spec == spec0
        assert replan(run, s, b) is run


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_replanned_solve_matches_the_eager_turned_solve(problems, kind):
    (c0, s0, b0, _), *turned = problems[0][kind]
    n = 1 if kind == "laplace" else 2
    run = planified(_step(s0, b0, n), s0, b0)
    run(*_args(c0, kind))
    for c, s, b, _ in turned:
        args = _args(c, kind)
        want = _step(s, b, n)(*args)
        assert replan(run, s, b) is run
        got = run(*args)
        scale = max(float(w.abs().max()) for w in want)
        assert max(float((g - w).abs().max())
                   for g, w in zip(got, want)) <= 1e-12 * scale


def _exact_twin(c, s):
    """The evaluator of ``s``'s sources as an unpadded registration makes
    it."""
    pq = c.pad_quantum
    c.pad_quantum = None
    try:
        return s._make_grid_evaluator(s.grid_src_x.numpy(),
                                      s.grid_src_y.numpy())
    finally:
        c.pad_quantum = pq


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_padded_apply_equals_the_exact_shape_apply(problems, kind):
    c, s, _, _ = problems[0][kind][1]
    pad, exact = s.grid_eval, _exact_twin(c, s)
    assert pad.padded and not exact.padded
    assert pad._patch_pieces.shape[0] >= exact._patch_pieces.shape[0]
    assert pad._patch_rows.shape[1] >= exact._patch_rows.shape[1]
    nzx, nzy = exact.spread_shape
    assert pad.spread_shape[0] >= nzx and pad.spread_shape[1] >= nzy
    rng = np.random.default_rng(20)
    qs = [torch.as_tensor(rng.standard_normal(s.grid_src_x.numel()))
          for _ in range(2 if kind == "stokes" else 1)]
    # the near corrections: the same pieces in the same order, and empty
    # rows and absent pieces past them
    n_out = pad._patch_shape[0] // (c.grid.Nx * c.grid.Ny)
    zero = torch.zeros(n_out, c.grid.Nx, c.grid.Ny, dtype=torch.float64)
    q = torch.cat(qs)
    assert torch.equal(pad._apply_patches(zero, q),
                       exact._apply_patches(zero, q))
    # the spread: zero columns and rows past the exact block
    spread = pad._spread(torch.stack(qs))
    want = exact._spread(torch.stack(qs))
    assert torch.equal(spread[:, nzx:], torch.zeros_like(spread[:, nzx:]))
    assert torch.equal(spread[:, :, nzy:],
                       torch.zeros_like(spread[:, :, nzy:]))
    scale = float(want.abs().max())
    assert float((spread[:, :nzx, :nzy] - want).abs().max()) \
        <= 1e-14 * scale
    got, want = pad(*qs), exact(*qs)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert float((g - w).abs().max()) <= 1e-14 * float(w.abs().max())


def test_capacity_overflow_is_counted_and_replan_misses(problems,
                                                        monkeypatch):
    (c0, s0, b0, _), (c1, s1, b1, _), _ = problems[0]["laplace"]
    run = planified(lambda *a: None, s0, b0)
    assert replan(run, s1, b1) is run
    # a bound below the rows the patches make: each evaluator keeps its
    # own piece table
    monkeypatch.setattr(tge, "_most_within", lambda *a: 0)
    take()
    with recording():
        s = PoissonSolver(c1)
        b = DirichletBIE(s)
    assert take().counts.get("plan.capacity_overflow", 0) == 2
    exact = _exact_twin(c1, s)
    assert s.grid_eval._patch_rows.shape == exact._patch_rows.shape
    with pytest.raises(ValueError, match="_patch_rows"):
        replan(run, s, b)


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_unpadded_registration_keeps_its_exact_shapes(problems, kind):
    c = _collection(pad_quantum=None)
    S, B = SOLVERS[kind]
    s = S(c)
    b = B(s)
    assert c.pad_quantum is None
    assert np.array_equal(c.pna_flat_dev.numpy(), c.pna_flat)
    for ev in (s.grid_eval, b.grid_eval):
        assert not ev.padded
        assert (tuple(ev._patch_pieces.shape), tuple(ev._patch_rows.shape),
                ev.spread_shape) == EXACT[kind]
