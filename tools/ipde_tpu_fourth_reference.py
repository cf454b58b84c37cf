"""ipde_tpu's errors, on the CPU and printed unrounded, on the problems that
chip_smoke.py's phase 7 runs through the port:

- fourth_poisson: the Poisson problem of chip_smoke.py's phase 2 (the
  reference paper's refinement row, star(1200, a=0.2, f=3), M = 16,
  qfs_tolerance 1e-14, fft grid backend) with solver_type="fourth", GMRES
  tol 1e-12 (maxiter 100, restart 30), DirichletBIE; the max error over the
  physical grid points and the radial nodes;
- fourth_stokes: the three-body Stokes problem of
  examples/stokes_refinement.py::run_case(700, 16) with
  solver_type="fourth" and the BIE radial plans of the port
  (tools/ipde_tpu_three_body_stokes.py --plans port);
- examples: the smallest default row of four example scripts:
  examples/poisson_refinement.py (200, 8),
  examples/mh_neumann_refinement.py (k = 1: 200, 10) and
  examples/advection_convergence.py (dt = 0.1, 2 steps to T = 0.2,
  nb = 200, M = 10; FE and BDF2) through their own run_case, and
  examples/stokes_refinement.py's (100, 8) with the BIE radial plans of
  the port (tools/ipde_tpu_three_body_stokes.py --nb 100 --M 8 --plans
  port);
- poisson_rows (not run by default: a few GB and ~2 min on an 8-core
  host): examples/poisson_refinement.py::run_case at (1800, 20) and
  (2600, 20), the largest row of its default sweep, which the port's
  examples/torch_poisson_refinement.py misses (ROADMAP.md Queue 3).

    JAX_PLATFORMS=cpu python tools/ipde_tpu_fourth_reference.py \\
        [--cases fourth_poisson fourth_stokes examples poisson_rows]

Prints one JSON line per case.  Writes nothing (the examples' main()
records into LEDGER_TPU.json; their run_case does not).
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _load(rel):
    """A script of the repo as a module."""
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fourth_poisson(nb=1200, M=16):
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.solvers.bie import DirichletBIE
    from ipde_tpu.solvers.scalar import PoissonSolver
    sol = lambda x, y: -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)  # noqa
    frc = lambda x, y: ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x)  # noqa
                         - np.cos(x) ** 3) * np.exp(np.sin(x)) * np.sin(y))
    bdy = star(nb, a=0.2, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)])
    grid = ebdyc.generate_grid(bh)
    solver = PoissonSolver(ebdyc, solver_type="fourth")
    ue, st = solver.solve_with_stats(
        EmbeddedFunction.from_function(ebdyc, frc), tol=1e-12, maxiter=100,
        restart=30)
    ue = DirichletBIE(solver).apply_bc(
        ue, BoundaryFunction.from_function(ebdyc, sol))
    e = ebdyc.ebdys[0]
    grid_err = float(np.abs(np.asarray(ue.grid) - sol(grid.xg, grid.yg))
                     [np.asarray(ebdyc.phys)].max())
    rad_err = float(np.abs(np.asarray(ue.radials[0])
                           - sol(e.radial_x, e.radial_y)).max())
    return {"case": "fourth_poisson", "nb": nb, "M": M,
            "err": max(grid_err, rad_err), "grid_err": grid_err,
            "radial_err": rad_err,
            "iterations": [int(i) for i in st["annular_iterations"]]}


def fourth_stokes(nb=700, M=16):
    out = _load("tools/ipde_tpu_three_body_stokes.py").run(
        nb, M, "fft", "port", "fourth")
    return dict(out, case="fourth_stokes")


def examples():
    poisson = _load("examples/poisson_refinement.py").run_case(200, 8)
    mhn = _load("examples/mh_neumann_refinement.py").run_case(1.0, 200, 10)
    adv = _load("examples/advection_convergence.py")
    fe = adv.run_case(0.1, 2, False, 200, 10)[0]
    bdf2 = adv.run_case(0.1, 2, True, 200, 10)[0]
    stokes = _load("tools/ipde_tpu_three_body_stokes.py").run(
        100, 8, "fft", "port")
    return {"case": "examples", "poisson_refinement_200_8": poisson["err"],
            "mh_neumann_refinement_k1_200_10": mhn["err"],
            "advection_convergence_dt0.1_fe": fe,
            "advection_convergence_dt0.1_bdf2": bdf2,
            "stokes_refinement_100_8_port_plans": stokes["err"]}


def poisson_rows():
    ex = _load("examples/poisson_refinement.py")
    return {"case": "poisson_rows",
            "rows": [ex.run_case(nb, M) for nb, M in ((1800, 20), (2600, 20))]}


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    cases = {"fourth_poisson": fourth_poisson, "fourth_stokes": fourth_stokes,
             "examples": examples, "poisson_rows": poisson_rows}
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="+", default=list(cases)[:3],
                    choices=list(cases))
    args = ap.parse_args()
    for case in args.cases:
        t0 = time.perf_counter()
        out = cases[case]()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
