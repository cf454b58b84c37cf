"""Interior-Poisson refinement study on the port (ipde_tpu_torch, on the
card): the counterpart of examples/poisson_refinement.py, with its problem,
sweep, reference rows and rule (reference: examples/poisson_for_paper.py:
108-131: err 5.5635e-04 @ nb=200, 9.6542e-07 @ 600, 2.5122e-11 @ 1200,
~7e-14 plateau at nb >= 2600).

For each nb the script builds the geometry, solves the inhomogeneous
problem (PoissonSolver, fft grid backend), applies the Dirichlet BIE
correction, and records err, dof, setup_s, first_s (the first solve, CUDA
library start-up included) and solve_ms (the median of 5 warm solves, with
min and max, each read after torch.cuda.synchronize()) into
LEDGER_TORCH.json under "poisson_refinement@<card>", each row with the
card's name and power limit.  There is no compile step (no planify).
Exit code 1 when a row misses 3 x its reference error.

GMRES tol 1e-13 as in the reference; see examples/_torch_common.py for the
port's rule (the true residual; a row that misses it raises).

Usage:
    python examples/torch_poisson_refinement.py              # on the card
    python examples/torch_poisson_refinement.py --device cpu
    POISSON_NBS="200,8 600,12 1200,16" python examples/torch_poisson_refinement.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_common as common  # noqa: E402


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


def run_case(nb, M, tol=1e-13, device=None):
    """One row on ``device`` (None: the card)."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import DirichletBIE
    from ipde_tpu_torch.solvers.scalar import PoissonSolver
    from ipde_tpu_torch.utils.profiling import sync, time_solves

    t0 = time.perf_counter()
    bdy = star(nb, a=0.2, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy], device=device)
    grid = ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)
    sync(f)
    setup_s = time.perf_counter() - t0

    def run():
        ue, st = solver.solve_with_stats(f, tol=tol, maxiter=100, restart=30)
        return bie.apply_bc(ue, bc), st

    (ue, st), times = time_solves(run, common.WARM_SOLVES)
    dof = int(ebdyc.phys.sum() + np.prod(ebdy.radial_shape))
    return {"nb": nb, "M": M, "err": common.max_err(ebdyc, ue, sol),
            "dof": dof, "grid": list(grid.shape), "setup_s": setup_s,
            **times, "iterations": st["annular_iterations"],
            "residual": max(st["annular_residuals"]), "tol": tol}


# reference ledger rows this sweep must meet or beat at matched nb
# (examples/poisson_for_paper.py:113, zeta=2 column)
REFERENCE_ERR = {200: 5.5635e-04, 600: 9.6542e-07, 1200: 2.5122e-11,
                 2600: 7.0e-14}


def check(row):
    """The reference's rule: within 3 x the reference row (plateau rows
    carry roundoff jitter)."""
    ref = REFERENCE_ERR.get(row["nb"])
    row["ref_err"] = ref
    row["beats_reference"] = ref is None or row["err"] <= 3 * ref
    return row["beats_reference"]


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    spec = os.environ.get("POISSON_NBS", "200,8 600,12 1200,16 2600,20")
    cases = [tuple(int(v) for v in c.split(",")) for c in spec.split()]
    print("# " + common.TOL_RULE, flush=True)
    print(f"{'nb':>6} {'M':>3} {'dof':>9} {'err':>10} {'ref_err':>10} "
          f"{common.TIME_HEAD}", flush=True)
    rows = []
    for nb, M in cases:
        row = run_case(nb, M, device=device)
        check(row)
        rows.append(row)
        ref = row["ref_err"]
        print(f"{nb:>6} {M:>3} {row['dof']:>9} {row['err']:>10.4e} "
              f"{(f'{ref:.4e}' if ref else '-'):>10} {common.time_cols(row)}",
              flush=True)
    from ipde_tpu_torch.utils.ledger import record
    record("poisson_refinement", rows, ("nb", "M"), device=device)
    bad = [r for r in rows if not r["beats_reference"]]
    print("ledger rows FAILED: " + json.dumps(bad) if bad
          else "all ledger rows met", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
