"""ipde_tpu's error on the three-body Stokes problem of
examples/stokes_refinement.py::run_case, on the CPU: the outer star(nb,
a=0.1, f=3) with M, two star inclusions of nb / 2 points with
M_i = max(M // 2 + 2, 6), the example's manufactured solution, solve tol
1e-12 (maxiter 100, restart 30), then StokesDirichletBIE.apply_bc.

    JAX_PLATFORMS=cpu python tools/ipde_tpu_three_body_stokes.py \\
        [--nb 700] [--M 16] [--backend fft|dense] [--plans ipde_tpu port]
        [--solver-type spectral|fourth]

``--plans ipde_tpu`` runs the BIE as ipde_tpu builds it; ``port`` first
gives the BIE the radial plans of ipde_tpu_torch (every source, except on
the interior boundary's own rows; ipde_tpu_torch/solvers/bie.py::
_radial_plans).  Prints one JSON line per variant: the max velocity error
over the physical grid points and every radial grid (the example's "err"),
split by grid and by boundary, the GMRES iterations, and per boundary the
largest Fourier mode above N / 2 (N the boundary's points) of the BIE's
effective density on its QFS source curve for the boundary data, relative
to its largest mode (what the stratified plans take as negligible; the
same for both variants).  Writes nothing
(the example's main() records into LEDGER_TPU.json; this does not).
About 60 s per variant at nb=700 on one CPU core.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def run(nb, M, backend, plans, solver_type="spectral"):
    from ipde_tpu.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu.ops.stratified import StratifiedRadialApply
    from ipde_tpu.solvers.bie import StokesDirichletBIE
    from ipde_tpu.solvers.vector import StokesSolver

    t0 = time.perf_counter()
    outer = star(nb, a=0.1, f=3)
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M,
             0.16 / M)
    Mi = max(M // 2 + 2, 6)
    nbi = max(nb // 2, 64)
    ebdyc = EmbeddedBoundaryCollection([
        EmbeddedBoundary(outer, True, M, bh),
        EmbeddedBoundary(star(nbi, x=0.3, y=0.18, r=0.16, a=0.05, f=4),
                         False, Mi, bh),
        EmbeddedBoundary(star(nbi, x=-0.28, y=-0.22, r=0.15, a=0.05, f=3),
                         False, Mi, bh)])
    grid = ebdyc.generate_grid(bh)
    solver = StokesSolver(ebdyc, grid_backend=backend,
                          solver_type=solver_type)
    bie = StokesDirichletBIE(solver)
    if plans == "port":
        for i, e in enumerate(ebdyc):
            for j, (src, ej) in enumerate(zip(bie.src_list, ebdyc)):
                if not (i == j and e.interior):
                    bie.radial_plans[i][j] = StratifiedRadialApply(
                        src, e.radial_x, e.radial_y,
                        k_density=ej.bdy.N // 2, max_stride=1)
    (u, v, p), st = solver.solve_with_stats(
        EmbeddedFunction.from_function(ebdyc, fuf),
        EmbeddedFunction.from_function(ebdyc, fvf), tol=1e-12, maxiter=100,
        restart=30)
    bcu = BoundaryFunction.from_function(ebdyc, usol)
    bcv = BoundaryFunction.from_function(ebdyc, vsol)
    u, v, p = bie.apply_bc(u, v, p, bcu, bcv)
    tau = np.asarray(bie.Ainv) @ np.concatenate(
        [np.concatenate([np.asarray(a), np.asarray(b)])
         for a, b in zip(bcu.values, bcv.values)])
    modes = []
    for i, (e, q, src) in enumerate(zip(ebdyc, bie.qfs_list, bie.src_list)):
        t = tau[bie.offs[i]:bie.offs[i + 1]]
        sig = np.asarray(q([t]) if e.interior else q([t, t]))[:src.N]
        amp = np.abs(np.fft.fft(sig))
        k = np.abs(np.fft.fftfreq(src.N, 1.0 / src.N))
        modes.append(float(amp[k > e.bdy.N // 2].max() / amp.max()))
    phys = np.asarray(ebdyc.phys)
    grid_err = max(
        np.abs(np.asarray(f.grid) - F(grid.xg, grid.yg))[phys].max()
        for f, F in ((u, usol), (v, vsol)))
    radial_err = [max(np.abs(np.asarray(f.radials[i])
                             - F(e.radial_x, e.radial_y)).max()
                      for f, F in ((u, usol), (v, vsol)))
                  for i, e in enumerate(ebdyc)]
    return {"nb": nb, "M": M, "Mi": Mi, "backend": backend, "plans": plans,
            "solver_type": solver_type,
            "err": float(max(grid_err, *radial_err)),
            "grid_err": float(grid_err),
            "radial_err": [float(r) for r in radial_err],
            "iterations": [int(i) for i in st["annular_iterations"]],
            "density_modes_above_half": modes,
            "grid": list(grid.shape),
            "seconds": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=700)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--backend", default="fft", choices=("fft", "dense"))
    ap.add_argument("--plans", nargs="+", default=["ipde_tpu", "port"],
                    choices=("ipde_tpu", "port"))
    ap.add_argument("--solver-type", default="spectral",
                    choices=("spectral", "fourth"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_enable_x64", True)
    for plans in args.plans:
        print(json.dumps(run(args.nb, args.M, args.backend, plans,
                             args.solver_type)), flush=True)


if __name__ == "__main__":
    main()
