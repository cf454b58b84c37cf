"""Pieces shared by the port's example scripts (examples/torch_*.py): the
device argument, the GMRES tolerance rule, the error measure, the timing
columns and the planified warm solve.

GMRES tolerance.  The port's annular solves check the TRUE residual and
raise above tol (ipde_tpu reports the Arnoldi estimate and never checks
it).  Its float64 floor is about 3e-14 for Poisson and 6.5e-14 for Stokes,
so the examples keep ipde_tpu's tol (1e-13 Poisson and Neumann, 1e-12
Stokes); a row whose true residual misses it raises, and no row of the
default sweeps does.
"""

from __future__ import annotations

import argparse

import numpy as np

# warm solves timed after the first (their median, min and max are printed)
WARM_SOLVES = 5
TOL_RULE = ("GMRES tol: the port checks the true residual and raises above "
            "tol (float64 floor ~3e-14 Poisson, ~6.5e-14 Stokes)")


def parse_device(description: str):
    """``--device``: None (the first CUDA card; the solvers raise without
    one) unless ``--device cpu`` (or another torch device) is passed."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the first CUDA card")
    return ap.parse_args().device


def max_err(ebdyc, ef, exact, shift: float = 0.0) -> float:
    """max |ef - exact - shift| over the physical grid points and every
    radial grid."""
    g = ebdyc.grid
    ge = np.abs(ef.grid.cpu().numpy() - exact(g.xg, g.yg) - shift)[
        ebdyc.phys].max()
    re = max(np.abs(fr.cpu().numpy() - exact(e.radial_x, e.radial_y)
                    - shift).max() for e, fr in zip(ebdyc, ef.radials))
    return float(max(ge, re))


def time_cols(row) -> str:
    """The timing columns of a printed row."""
    return (f"{row['setup_s']:>8.2f} {row['first_s']:>8.2f} "
            f"{row['solve_ms']:>9.2f} ({row['solve_ms_min']:.2f}-"
            f"{row['solve_ms_max']:.2f})")


TIME_HEAD = (f"{'setup_s':>8} {'first_s':>8} {'solve_ms':>9} (min-max of "
             f"{WARM_SOLVES} warm)")
PLAN_HEAD = f"{'plan_first_s':>12} {'planified_ms':>12} (min-max)"


def plan_cols(row) -> str:
    """The planified columns of a printed row."""
    return (f"{row['planified_first_s']:>12.2f} {row['planified_ms']:>12.2f} "
            f"({row['planified_ms_min']:.2f}-{row['planified_ms_max']:.2f})")


def planified_times(step, roots, args):
    """The warm solve through ``utils.planify.planified(step, *roots)``, as
    the reference drivers time it: the first call (on a card: warm-up and
    CUDA-graph capture) and then WARM_SOLVES calls, each read after the
    synchronization of its result.  Returns (the first call's output,
    {"planified_first_s", "planified_ms" (median), "planified_ms_min",
    "planified_ms_max"})."""
    from ipde_tpu_torch.utils.planify import planified
    from ipde_tpu_torch.utils.profiling import time_solves
    run = planified(step, *roots)
    out, t = time_solves(lambda: run(*args), WARM_SOLVES)
    return out, {"planified_first_s": t["first_s"],
                 "planified_ms": t["solve_ms"],
                 "planified_ms_min": t["solve_ms_min"],
                 "planified_ms_max": t["solve_ms_max"]}


def host_stats(st) -> dict:
    """The solve's GMRES stats (device tensors) as ledger values."""
    return {"iterations": [int(i) for i in st["annular_iterations"]],
            "residual": max(float(r) for r in st["annular_residuals"])}
