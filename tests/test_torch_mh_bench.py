"""The benchmark's Yukawa configuration on the CPU: the manufactured
solution of ``perfbench/equations/modified_helmholtz_k2.py`` solves its own
equation, and the benchmark's planified step (``perfbench/harness/
planstep.py::plan_step``) on a small copy of the configuration reproduces
it at every physical grid point and radial node.

The small problem: ``ModifiedHelmholtzSolver(k=2)`` + ``DirichletBIE`` on
star(128, a=0.2, f=5), M = 8, fft grid backend, device set-up backend,
built as the harness builds the configuration (``harness/problem.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_testing import one_torch_thread  # noqa: F401

from perfbench.harness import problem, spec
from perfbench.harness.planstep import plan_step
from perfbench.harness.traffic import Schedule
from perfbench.reference.compare import errors
from perfbench.reference.geometry import Geometry as ReferenceGeometry

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs"
                     / "mh_star800_M20_k2.json").read_text())
FIXED = json.loads((ROOT / "perfbench" / "traffic" / "fixed.json")
                   .read_text())
EQ = spec.load_module(ROOT / "perfbench" / "equations"
                      / "modified_helmholtz_k2.py", "equation")
SEEDS = (7, 2 ** 31 + 5)
# the small step's error is 5.8e-6 and 4.6e-6 on the two seeds (M = 8
# radial nodes resolve the waves of |k| <= 3 only so far); a forcing with
# kappa = 0 reads 0.11 and 0.056, and the grid symbol 1 / (-k^2 - lap) in
# place of 1 / (k^2 - lap) 0.68: 1e-4 lies 17x above the first and 500x
# below the others
STEP_TOL = 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_forcing_is_the_operator_of_exact(seed):
    """f = (kappa^2 - lap) u by a fourth-order finite difference of
    ``exact``, and g = ``exact``, on seeded draws."""
    p = Schedule(FIXED, EQ, seed).bank[0]
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-1.2, 1.2, (2, 200))
    d = 1e-2
    u = lambda a, b: EQ.exact(p, a, b)["u"]  # noqa: E731
    c = (-1.0, 16.0, -30.0, 16.0, -1.0)
    lap = sum(ci * (u(x + (i - 2) * d, y) + u(x, y + (i - 2) * d))
              for i, ci in enumerate(c)) / (12.0 * d * d)
    want = EQ.KAPPA ** 2 * u(x, y) - lap
    (f,) = EQ.forcing(p, x, y, np)
    # the difference's truncation error: |k|^6 d^4 / 90 <= 8.1e-8 a wave
    assert np.abs(f - want).max() < 1e-6
    (g,) = EQ.boundary(p, x, y, np)
    assert np.array_equal(g, u(x, y))
    (f_t,) = EQ.forcing(p, torch.as_tensor(x), torch.as_tensor(y), torch)
    assert torch.allclose(f_t, torch.as_tensor(f), rtol=0, atol=1e-14)


def test_kappa_is_the_configurations():
    assert EQ.KAPPA == CONFIG["solver_kw"]["k"] == 2.0
    assert CONFIG["equation"] == "modified_helmholtz_k2"


@pytest.fixture(scope="module")
def small():
    cfg = json.loads(json.dumps(CONFIG))
    cfg["boundary"]["N"], cfg["M"] = 128, 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IPDE_QFS_BACKEND", "device")
        geo = problem.Geometry(cfg, torch.device("cpu"))
        solver, bie = problem.solve_objects(cfg, geo)
    gmres = dict(cfg["gmres"], tol=1e-12)
    call = problem.plan(plan_step(solver, bie, EQ.FORCING, EQ.BOUNDARY,
                                  gmres), solver, bie)
    return geo, call, ReferenceGeometry(cfg)


def _step_error(small, seed, kappa=None):
    geo, call, ref = small
    p = Schedule(FIXED, EQ, seed).bank[0]
    if kappa is not None:
        kept, EQ.KAPPA = EQ.KAPPA, kappa
    try:
        args = problem.inputs(EQ, p, geo)
    finally:
        if kappa is not None:
            EQ.KAPPA = kept
    flat, _ = call(*args)
    fields = {"u": (flat[0].numpy(), flat[1].numpy())}
    return errors(EQ, p, fields, ref)["u_err"]


@pytest.mark.parametrize("seed", SEEDS)
def test_planified_step_matches_exact(small, seed):
    assert _step_error(small, seed) < STEP_TOL


def test_forcing_without_kappa_fails_the_tolerance(small):
    assert _step_error(small, SEEDS[0], kappa=0.0) > 100 * STEP_TOL
