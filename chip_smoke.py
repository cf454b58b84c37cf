"""GPU smoke run of the ipde_tpu_torch port: the quickest proof that the port
builds and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. require a CUDA device; print the card's name and power limit; build the
     CUDA kernel from ``ipde_tpu_torch/csrc`` and print the build seconds.
  2. compare the Laplace single-layer kernel with its plain torch version on
     near-coincident test clouds and at the shapes of the Poisson solve below
     (max relative difference <= 1e-12); print both times.
  3. run the interior Poisson Dirichlet solve of the reference paper's
     refinement row on the GPU: star(1200, a=0.2, f=3), M=16,
     qfs_tolerance=1e-14 (a 544x576 box grid, 201,824 dof), through
     PoissonSolver.solve_with_stats + DirichletBIE.apply_bc; require max
     error < 2.5e-11 against the analytic solution, an annular GMRES
     residual <= tol, and kernel launches from that run.
  4. print the kernels' JSON line, then the device JSON line last.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL_KERNEL_REL = 1e-12
TOL_SOLVE_ERR = 2.5e-11


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


def _ds_round(x):
    hi = x.astype(np.float32).astype(np.float64)
    lo = (x - hi).astype(np.float32).astype(np.float64)
    return hi + lo


def cloud(T=700, S=300, seed=0):
    """The near-coincident source/target cloud of tests/test_pallas_ds.py."""
    rng = np.random.default_rng(seed)
    sx = np.cos(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    sy = np.sin(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    r = 0.8 * np.sqrt(rng.uniform(0.01, 1, T))
    th = rng.uniform(0, 2 * np.pi, T)
    tx = r * np.cos(th)
    ty = r * np.sin(th)
    k = min(32, T)
    tx[:k] = sx[:k] + 10.0 ** rng.uniform(-4, -2, k)
    ty[:k] = sy[:k] + 10.0 ** rng.uniform(-4, -2, k)
    q = rng.standard_normal(S) / S
    return tuple(_ds_round(a) for a in (sx, sy, q, tx, ty))


def cuda_ms(fn, reps=5):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(K, label, sx, sy, q, tx, ty, timed=False):
    """Kernel vs plain version on one input set; returns (max abs diff,
    max rel diff, kernel ms, plain ms)."""
    got = K.laplace_slp_apply(sx, sy, q, tx, ty)
    want = K.laplace_slp_apply_plain(sx, sy, q, tx, ty)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: kernel output is not finite")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / float(want.abs().max())
    ms = plain_ms = float("nan")
    if timed:
        ms = cuda_ms(lambda: K.laplace_slp_apply(sx, sy, q, tx, ty))
        plain_ms = cuda_ms(lambda: K.laplace_slp_apply_plain(sx, sy, q, tx, ty))
    print(f"# kernel {label}: T={tx.shape[0]} S={sx.shape[0]} "
          f"max_abs={abs_err:.3e} max_rel={rel_err:.3e} "
          f"(tol {TOL_KERNEL_REL:.0e})"
          + (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if timed else ""),
          flush=True)
    if not rel_err <= TOL_KERNEL_REL:
        raise RuntimeError(f"{label}: kernel disagrees with the plain "
                           f"version: max rel {rel_err:.3e} > {TOL_KERNEL_REL}")
    return abs_err, ms, plain_ms


def build_problem(dev, nb=1200, M=16):
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import DirichletBIE
    from ipde_tpu_torch.solvers.scalar import PoissonSolver

    bdy = star(nb, a=0.2, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy], device=dev)
    grid = ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)
    return ebdyc, grid, f, bc, solver, bie


def main():
    # ---- phase 1: device, card, build ------------------------------------
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import kernels as K

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    K.load_library()
    print(f"# build laplace_slp.cu: {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---- phase 2a: kernel vs plain on near-coincident clouds --------------
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    errs = []
    for seed in (0, 4):
        errs.append(compare(K, f"cloud seed {seed}",
                            *map(as_dev, cloud(seed=seed)))[0])

    # ---- phase 3a: set up the nb=1200, M=16 Poisson problem --------------
    t0 = time.perf_counter()
    ebdyc, grid, f, bc, solver, bie = build_problem(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dof = int(ebdyc.phys.sum() + np.prod(ebdyc.ebdys[0].radial_shape))
    print(f"# setup {setup_s:.2f} s: grid {grid.shape}, {dof} dof, "
          f"{solver.grid_src_x.shape[0]} merged QFS sources", flush=True)

    # ---- phase 2b: kernel vs plain at the solve's shapes ------------------
    rng = np.random.default_rng(1)
    S = solver.grid_src_x.shape[0]
    q = as_dev(rng.standard_normal(S) / S)
    merged = (solver.grid_src_x, solver.grid_src_y, q, solver._dense_tx,
              solver._dense_ty)
    e, ms, plain_ms = compare(K, "merged sigma_g -> pna+interface", *merged,
                              timed=True)
    errs.append(e)
    src = bie.src_list[0].dev(dev)
    errs.append(compare(K, "BIE source -> physical grid", src["x"], src["y"],
                        q[:src["x"].shape[0]].contiguous(), bie.phys_x,
                        bie.phys_y)[0])
    f0, tx, ty, gsx, gsy, gw = bie.radial_plans[0][0].groups[0]
    errs.append(compare(K, f"BIE source -> radial rows (stride {f0})", gsx,
                        gsy, gw, tx, ty)[0])

    # ---- phase 3b: the main path, counted --------------------------------
    tol = 1e-12

    def run():
        ue, stats = solver.solve_with_stats(f, tol=tol, maxiter=100,
                                            restart=30)
        ue = bie.apply_bc(ue, bc)
        torch.cuda.synchronize()
        return ue, stats

    K.laplace_slp_apply.launches = 0
    t0 = time.perf_counter()
    ue, stats = run()
    first_s = time.perf_counter() - t0
    launches = K.laplace_slp_apply.launches
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        warm.append(time.perf_counter() - t0)
    phys = ebdyc.phys
    ua_grid = sol(grid.xg, grid.yg)
    e0 = ebdyc.ebdys[0]
    grid_err = float(np.abs(ue.grid.cpu().numpy() - ua_grid)[phys].max())
    rad_err = float(np.abs(ue.radials[0].cpu().numpy()
                           - sol(e0.radial_x, e0.radial_y)).max())
    err = max(grid_err, rad_err)
    iters = stats["annular_iterations"][0]
    resid = stats["annular_residuals"][0]
    print(f"# solve: first {first_s * 1e3:.1f} ms, warm median "
          f"{statistics.median(warm) * 1e3:.1f} ms "
          f"(runs {', '.join(f'{w * 1e3:.1f}' for w in warm)} ms), "
          f"{iters} GMRES iterations, residual {resid:.3e}, "
          f"max error {err:.3e} (grid {grid_err:.3e}, radial {rad_err:.3e}), "
          f"laplace_slp launches {launches}", flush=True)
    if not (math.isfinite(err) and err < TOL_SOLVE_ERR):
        raise RuntimeError(f"solve error {err:.3e} >= {TOL_SOLVE_ERR}")
    if not resid <= tol:
        raise RuntimeError(f"annular GMRES residual {resid:.3e} > {tol}")
    if launches <= 0:
        raise RuntimeError("the solve launched no laplace_slp kernel")

    # ---- phase 4: results --------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "laplace_slp", "route": "cuda",
        "source": "ipde_tpu_torch/csrc/laplace_slp.cu",
        "replaces": "ipde_tpu/ops/pallas_ds.py:469",
        "launches": launches, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
