"""3-body Stokes refinement study on the port (ipde_tpu_torch, on the card):
the counterpart of examples/stokes_refinement.py, with its geometry, sweep,
reference rows and rule (reference: examples/multi_stokes_for_paper.py:
247-249: max rel err 2.5864e-01 @ nb=100, 4.8345e-07 @ 400, 3.3441e-10 @
700, 7.5079e-10 plateau @ 1000).

Geometry: star-shaped outer boundary with two star-shaped inclusions of
half the points (STOKES_NBI_FACTOR=1: the same), M_i = max(M // 2 + 2, 6).
The error is the max abs velocity error over the physical grid and every
radial grid.  Rows (err, dof, setup_s, first_s, solve_ms: the median of 5
warm solves with min and max, read after torch.cuda.synchronize()) go into
LEDGER_TORCH.json under "stokes_refinement@<card>", with the warm solve
also timed through ``utils.planify.planified`` as
examples/stokes_refinement.py does (planified_first_s: warm-up and
capture on a card; planified_ms: median, min, max of 5); the planified
velocity must agree with the eager one to 1e-13 of its max, and the error
and the rule are the eager solve's.  Exit code 1 when a row misses 3 x its
reference error.

The port's BIE takes every source in the radial plans of an inclusion and
of another boundary (ipde_tpu subsamples them; ROADMAP.md Queue 3), so its
errors differ from ipde_tpu's on the same rows.  GMRES tol 1e-12 as in the
reference; see examples/_torch_common.py for the port's rule.

Usage:
    python examples/torch_stokes_refinement.py              # on the card
    python examples/torch_stokes_refinement.py --device cpu
    STOKES_NBS="100,8 400,12" python examples/torch_stokes_refinement.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_common as common  # noqa: E402


def usol(x, y):
    return np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)


def vsol(x, y):
    return -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)


def fu(x, y):
    return (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
            - np.sin(x) * np.sin(y))


def fv(x, y):
    return (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
            + np.cos(x) * np.cos(y))


def run_case(nb, M, tol=1e-12, device=None):
    """One row on ``device`` (None: the card)."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
    from ipde_tpu_torch.solvers.vector import StokesSolver
    from ipde_tpu_torch.utils.profiling import sync, time_solves

    t0 = time.perf_counter()
    outer = star(nb, a=0.1, f=3)
    # cap the strip width so the three annuli stay disjoint even at the
    # coarsest nb (inclusion gaps ~0.35; M*bh <= 0.16 keeps them apart)
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M,
             0.16 / M)
    Mi = max(M // 2 + 2, 6)
    fac = float(os.environ.get("STOKES_NBI_FACTOR", "0.5"))
    nbi = max(int(nb * fac), 64)
    ebdyc = EmbeddedBoundaryCollection([
        EmbeddedBoundary(outer, True, M, bh),
        EmbeddedBoundary(star(nbi, x=0.3, y=0.18, r=0.16, a=0.05, f=4),
                         False, Mi, bh),
        EmbeddedBoundary(star(nbi, x=-0.28, y=-0.22, r=0.15, a=0.05, f=3),
                         False, Mi, bh)], device=device)
    ebdyc.generate_grid(bh)
    FU = EmbeddedFunction.from_function(ebdyc, fu)
    FV = EmbeddedFunction.from_function(ebdyc, fv)
    bu = BoundaryFunction.from_function(ebdyc, usol)
    bv = BoundaryFunction.from_function(ebdyc, vsol)
    solver = StokesSolver(ebdyc)
    bie = StokesDirichletBIE(solver)
    sync(FU)
    setup_s = time.perf_counter() - t0

    def run():
        (u, v, p), st = solver.solve_with_stats(FU, FV, tol=tol, maxiter=100,
                                                restart=30)
        return bie.apply_bc(u, v, p, bu, bv), st

    def step(fg, gg, *frs):
        k = len(frs) // 2
        u, v, p = solver(EmbeddedFunction(fg, list(frs[:k])),
                         EmbeddedFunction(gg, list(frs[k:])),
                         tol=tol, maxiter=100, restart=30)
        u, v, p = bie.apply_bc(u, v, p, bu, bv)
        return (u.grid, v.grid) + tuple(u.radials) + tuple(v.radials)

    ((u, v, _), st), times = time_solves(run, common.WARM_SOLVES)
    out, plan_times = common.planified_times(
        step, (solver, bie), (FU.grid, FV.grid, *FU.radials, *FV.radials))
    scale = max(float(u.grid.abs().max()), float(v.grid.abs().max()))
    gap = max(float((a - b).abs().max()) for a, b in zip(out, (
        u.grid, v.grid, *u.radials, *v.radials))) / scale
    if not gap <= 1e-13:
        raise RuntimeError(f"nb={nb}: the planified solve differs from the "
                           f"eager one by {gap:.3e} of max |u|, |v|")
    err = max(common.max_err(ebdyc, u, usol), common.max_err(ebdyc, v, vsol))
    dof = int(ebdyc.phys.sum() + sum(np.prod(e.radial_shape)
                                     for e in ebdyc))
    return {"nb": nb, "M": M, "err": err, "dof": dof,
            "grid": list(ebdyc.grid.shape), "setup_s": setup_s, **times,
            **plan_times, **common.host_stats(st), "tol": tol}


# reference ledger (examples/multi_stokes_for_paper.py:249)
REFERENCE_ERR = {100: 2.5864e-01, 400: 4.8345e-07, 700: 3.3441e-10,
                 1000: 7.5079e-10}


def check(row):
    """The reference's rule: within 3 x the reference row."""
    ref = REFERENCE_ERR.get(row["nb"])
    row["ref_err"] = ref
    row["beats_reference"] = ref is None or row["err"] <= 3 * ref
    return row["beats_reference"]


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    spec = os.environ.get("STOKES_NBS", "100,8 400,12 700,16")
    cases = [tuple(int(v) for v in c.split(",")) for c in spec.split()]
    print("# " + common.TOL_RULE, flush=True)
    print(f"{'nb':>6} {'M':>3} {'dof':>9} {'err':>10} {'ref_err':>10} "
          f"{common.TIME_HEAD} {common.PLAN_HEAD}", flush=True)
    rows = []
    for nb, M in cases:
        row = run_case(nb, M, device=device)
        check(row)
        rows.append(row)
        ref = row["ref_err"]
        print(f"{nb:>6} {M:>3} {row['dof']:>9} {row['err']:>10.4e} "
              f"{(f'{ref:.4e}' if ref else '-'):>10} {common.time_cols(row)} "
              f"{common.plan_cols(row)}",
              flush=True)
    from ipde_tpu_torch.utils.ledger import record
    record("stokes_refinement", rows, ("nb", "M"), device=device)
    bad = [r for r in rows if not r["beats_reference"]]
    print("ledger rows FAILED: " + json.dumps(bad) if bad
          else "all ledger rows met", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
