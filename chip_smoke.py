"""GPU smoke run of the ipde_tpu_torch port: the quickest proof that the port
builds and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed; each
phase prints its seconds):
  1. require a CUDA device; print the card's name and power limit; build the
     CUDA kernels from ``ipde_tpu_torch/csrc`` (one nvcc per source, started
     together) and print the build seconds.
  2. Poisson: compare the Laplace single-layer kernel with its plain torch
     version on near-coincident test clouds and at the shapes of the Poisson
     solve (max relative difference <= 1e-12); run the interior Poisson
     Dirichlet solve of the reference paper's refinement row,
     star(1200, a=0.2, f=3), M=16, qfs_tolerance=1e-14 (a 544x576 box grid,
     201,824 dof), through PoissonSolver.solve_with_stats +
     DirichletBIE.apply_bc; require max error < 2.5e-11 against the
     analytic solution, an annular GMRES residual <= tol, and laplace_slp
     launches from that run.
  3. Stokes: compare the Stokeslet kernel with its plain torch version on
     the clouds and at the shapes of the Stokes solve (u, v relative to
     max|u|, max|v|; p relative to max(1, |p|) per row; <= 1e-12); run the
     interior Stokes velocity-Dirichlet solve of bench.py's tier 1,
     star(1200, a=0.2, f=5), M=16, qfs_tolerance=1e-14, grid_target=1024
     (a 1024x1088 box grid), through StokesSolver.solve_with_stats +
     StokesDirichletBIE.apply_bc with bench.py's manufactured solution;
     require a velocity error < 3.3441e-10 (the reference paper's Stokes
     plateau), a pressure error < 8e-8 after its mean over the physical
     points is removed, an annular GMRES residual <= tol, and stokes_slp
     launches from that run.
  4. print the kernels' JSON line, the card's name and power limit, then
     the device JSON line last.

Each main path runs with every kernel's launch count set to 0 just before
it and read just after; the comparisons with the plain versions are not
counted.  ``bound_ms`` is the larger of the bytes the function must move
(each input read once, each output written once) over 3.35 TB/s and its
FP64 operations over 34 TFLOP/s, the H100 SXM's FP64 peak outside the
tensor cores (NVIDIA H100 data sheet); operations are counted per
target-source pair with an FMA as two and a log or a reciprocal as one.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL_KERNEL_REL = 1e-12
TOL_SOLVE_ERR = 2.5e-11          # Poisson, nb=1200 (reference ledger)
TOL_STOKES_VEL = 3.3441e-10      # reference Stokes plateau
TOL_STOKES_P = 8e-8              # tests/test_interior_stokes.py
GMRES_TOL = 1e-12
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# FP64 operations per target-source pair (FMA = 2, log = reciprocal = 1):
# laplace: 2 sub, r^2 (mul + FMA), max, log, FMA accumulate
# stokes: 2 sub, r^2 (mul + FMA), max, reciprocal, log, mul, the force
#         projection (mul + FMA + mul), two FMA pairs into u and v, add to p
OPS_PER_PAIR = {"laplace_slp": 9, "stokes_slp": 22}


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


# bench.py's Stokes manufactured solution; p = cos x sin y up to a constant
def usol(x, y):
    return np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)


def vsol(x, y):
    return -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)


def psol(x, y):
    return np.cos(x) * np.sin(y)


def fuf(x, y):
    return (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
            - np.sin(x) * np.sin(y))


def fvf(x, y):
    return (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
            + np.cos(x) * np.cos(y))


def _ds_round(x):
    hi = x.astype(np.float32).astype(np.float64)
    lo = (x - hi).astype(np.float32).astype(np.float64)
    return hi + lo


def cloud(T=700, S=300, seed=0):
    """The near-coincident source/target cloud of tests/test_pallas_ds.py,
    with a second charge column: (sx, sy, q, q2, tx, ty)."""
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
    q2 = np.random.default_rng(seed + 1).standard_normal(S) / S
    return tuple(_ds_round(a) for a in (sx, sy, q, q2, tx, ty))


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


def laplace_err(got, want):
    """(max abs difference, max difference relative to max|want|)."""
    a = float((got - want).abs().max())
    return a, a / float(want.abs().max())


def stokes_err(got, want):
    """(max abs difference, max relative difference): u and v relative to
    max|u| and max|v|, p relative to max(1, |p|) per row."""
    a = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got[:2], want[:2]))
    rel = max(rel, float(((got[2] - want[2]).abs()
                          / want[2].abs().clamp_min(1.0)).max()))
    return a, rel


def bound_ms(name, S, T):
    """The least time the card could take for one apply: see the module
    docstring."""
    n_in, n_out = {"laplace_slp": (3, 1), "stokes_slp": (4, 3)}[name]
    nbytes = 8 * (n_in * S + 2 * T + n_out * T)
    ops = OPS_PER_PAIR[name] * S * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else \
        "operations"


def compare(kernel, plain, err, label, args, timed=False):
    """Kernel vs plain version on one input set; returns (max abs diff,
    kernel ms, plain ms)."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError(f"{label}: kernel output is not finite")
    abs_err, rel_err = err(got, want)
    ms = plain_ms = float("nan")
    if timed:
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
    print(f"# {kernel.__name__} {label}: T={args[-1].shape[0]} "
          f"S={args[0].shape[0]} max_abs={abs_err:.3e} max_rel={rel_err:.3e} "
          f"(tol {TOL_KERNEL_REL:.0e})"
          + (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if timed else ""),
          flush=True)
    if not rel_err <= TOL_KERNEL_REL:
        raise RuntimeError(f"{label}: kernel disagrees with the plain "
                           f"version: max rel {rel_err:.3e} > {TOL_KERNEL_REL}")
    return abs_err, ms, plain_ms


def build_problem(dev, nb=1200, M=16):
    """The Poisson problem of the reference paper's refinement row."""
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


def build_stokes_problem(dev=None, nb=1200, M=16, grid_target=1024):
    """bench.py's Stokes problem (tier 1 at the defaults): h as bench.py
    sizes it for grid_target; the collection on ``dev`` (None: the card)."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
    from ipde_tpu_torch.solvers.vector import StokesSolver

    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    bh = min(bh, float(bdy.x.max() - bdy.x.min()) / (grid_target - 3 * M))
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy], device=dev)
    grid = ebdyc.generate_grid(bh)
    fu = EmbeddedFunction.from_function(ebdyc, fuf)
    fv = EmbeddedFunction.from_function(ebdyc, fvf)
    bcs = (BoundaryFunction.from_function(ebdyc, usol),
           BoundaryFunction.from_function(ebdyc, vsol))
    solver = StokesSolver(ebdyc)
    bie = StokesDirichletBIE(solver)
    return ebdyc, grid, (fu, fv), bcs, solver, bie


def max_err(ebdyc, ef, f, shift=0.0):
    """max |ef - f - shift| over the physical grid points and radial
    nodes."""
    g = ebdyc.grid
    e0 = ebdyc.ebdys[0]
    grid_err = np.abs(ef.grid.cpu().numpy() - f(g.xg, g.yg)
                      - shift)[ebdyc.phys].max()
    rad_err = np.abs(ef.radials[0].cpu().numpy()
                     - f(e0.radial_x, e0.radial_y) - shift).max()
    return float(grid_err), float(rad_err)


def timed_runs(run, counters):
    """Drive ``run`` once with every launch count set to 0 just before and
    read just after, then three warm runs; returns (result, launches by
    kernel, first s, warm s list)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = run()
    first = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        warm.append(time.perf_counter() - t0)
    return out, launches, first, warm


def poisson_phase(dev, K, counters):
    t_phase = time.perf_counter()
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    lap = (K.laplace_slp_apply, K.laplace_slp_apply_plain, laplace_err)
    errs = []
    for seed in (0, 4):
        sx, sy, q, _, tx, ty = map(as_dev, cloud(seed=seed))
        errs.append(compare(*lap, f"cloud seed {seed}",
                            (sx, sy, q, tx, ty))[0])

    t0 = time.perf_counter()
    ebdyc, grid, f, bc, solver, bie = build_problem(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dof = int(ebdyc.phys.sum() + np.prod(ebdyc.ebdys[0].radial_shape))
    print(f"# poisson setup {setup_s:.2f} s: grid {grid.shape}, {dof} dof, "
          f"{solver.grid_src_x.shape[0]} merged QFS sources", flush=True)

    rng = np.random.default_rng(1)
    S = solver.grid_src_x.shape[0]
    q = as_dev(rng.standard_normal(S) / S)
    merged = (solver.grid_src_x, solver.grid_src_y, q, solver._dense_tx,
              solver._dense_ty)
    e, ms, plain_ms = compare(*lap, "merged sigma_g -> pna+interface",
                              merged, timed=True)
    errs.append(e)
    src = bie.src_list[0].dev(dev)
    errs.append(compare(*lap, "BIE source -> physical grid",
                        (src["x"], src["y"], q[:src["x"].shape[0]]
                         .contiguous(), bie.phys_x, bie.phys_y))[0])
    f0, tx, ty, gsx, gsy, gw = bie.radial_plans[0][0].groups[0]
    errs.append(compare(*lap, f"BIE source -> radial rows (stride {f0})",
                        (gsx, gsy, gw, tx, ty))[0])

    def run():
        ue, stats = solver.solve_with_stats(f, tol=GMRES_TOL, maxiter=100,
                                            restart=30)
        ue = bie.apply_bc(ue, bc)
        torch.cuda.synchronize()
        return ue, stats

    (ue, stats), launches, first_s, warm = timed_runs(run, counters)
    grid_err, rad_err = max_err(ebdyc, ue, sol)
    err = max(grid_err, rad_err)
    iters = stats["annular_iterations"][0]
    resid = stats["annular_residuals"][0]
    print(f"# poisson solve: first {first_s * 1e3:.1f} ms, warm median "
          f"{statistics.median(warm) * 1e3:.1f} ms "
          f"(runs {', '.join(f'{w * 1e3:.1f}' for w in warm)} ms), "
          f"{iters} GMRES iterations, residual {resid:.3e}, "
          f"max error {err:.3e} (grid {grid_err:.3e}, radial {rad_err:.3e}), "
          f"launches {launches}", flush=True)
    if not (math.isfinite(err) and err < TOL_SOLVE_ERR):
        raise RuntimeError(f"poisson solve error {err:.3e} >= {TOL_SOLVE_ERR}")
    if not resid <= GMRES_TOL:
        raise RuntimeError(f"annular GMRES residual {resid:.3e} > {GMRES_TOL}")
    if launches["laplace_slp"] <= 0:
        raise RuntimeError("the Poisson solve launched no laplace_slp kernel")
    print(f"# poisson phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    bnd, by = bound_ms("laplace_slp", S, merged[3].shape[0])
    return {"name": "laplace_slp", "route": "cuda",
            "source": "ipde_tpu_torch/csrc/laplace_slp.cu",
            "replaces": "ipde_tpu/ops/pallas_ds.py:469",
            "launches": launches["laplace_slp"], "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def gmres_floor(solver, fu, fv, tols=(1e-13, 3e-14)):
    """The annular Stokes GMRES of the solve, run alone at tighter tols:
    (tol, iterations, true residual) for each, without raising."""
    from ipde_tpu_torch.ops.gmres import gmres
    from ipde_tpu_torch.solvers import annular_stokes as ann
    h = solver.helpers[0]
    a = h.annular_solver
    ops = a.make_ops(h.metric)
    z = h.zero_bc
    rhs = a.build_rhs(*h.uv_to_rt(fu.radials[0], fv.radials[0]), z, z, z, z)
    out = []
    for tol in tols:
        res = gmres(lambda x: ann._matvec(ops, x, a.M, a.n), rhs,
                    precond=lambda x: ann._precond(ops, x, a.M, a.n),
                    tol=tol, maxiter=100, restart=30)
        out.append((tol, res.iterations, res.residual))
    return out


def stokes_phase(dev, SK, counters):
    t_phase = time.perf_counter()
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    sto = (SK.stokes_slp_apply, SK.stokes_slp_apply_plain, stokes_err)
    errs = [compare(*sto, f"cloud seed {seed}",
                    tuple(map(as_dev, cloud(seed=seed))))[0]
            for seed in (2, 5)]

    t0 = time.perf_counter()
    ebdyc, grid, (fu, fv), (bcu, bcv), solver, bie = build_stokes_problem()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e0 = ebdyc.ebdys[0]
    dof = int(ebdyc.phys.sum() + np.prod(e0.radial_shape))
    n_pna = ebdyc.pna_x.size
    T_merged = solver._dense_tx.shape[0]
    classes = (type(ebdyc.interface_interp).__name__,
               type(ebdyc.radial_to_grid_plans[0]).__name__)
    print(f"# stokes setup {setup_s:.2f} s: grid {grid.shape}, {dof} dof, "
          f"{n_pna} pna + {T_merged - n_pna} interface = {T_merged} merged "
          f"targets, {solver.grid_src_x.shape[0]} merged QFS sources, "
          f"{bie.phys_x.shape[0]} physical points; interface plan "
          f"{classes[0]}, radial plan {classes[1]}", flush=True)
    if classes[1] != "HybridInterp2D":
        raise RuntimeError(f"the radial plan is {classes[1]}, not "
                           "HybridInterp2D")

    rng = np.random.default_rng(3)
    S = solver.grid_src_x.shape[0]
    q = [as_dev(rng.standard_normal(S) / S) for _ in range(2)]
    merged = (solver.grid_src_x, solver.grid_src_y, q[0], q[1],
              solver._dense_tx, solver._dense_ty)
    e, ms, plain_ms = compare(*sto, "merged sigma_g -> pna+interface",
                              merged, timed=True)
    errs.append(e)
    src = bie.src.dev(dev)
    n = src["x"].shape[0]
    errs.append(compare(*sto, "BIE source -> physical grid",
                        (src["x"], src["y"], q[0][:n].contiguous(),
                         q[1][:n].contiguous(), bie.phys_x, bie.phys_y))[0])
    f0, tx, ty, gsx, gsy, gw = bie.radial_plan.groups[0]
    errs.append(compare(*sto, f"BIE source -> radial rows (stride {f0})",
                        (gsx, gsy, gw, gw.flip(0).contiguous(), tx, ty))[0])

    def run():
        (u, v, p), stats = solver.solve_with_stats(
            fu, fv, tol=GMRES_TOL, maxiter=100, restart=30)
        u, v, p = bie.apply_bc(u, v, p, bcu, bcv)
        torch.cuda.synchronize()
        return (u, v, p), stats

    ((u, v, p), stats), launches, first_s, warm = timed_runs(run, counters)
    vel = [max_err(ebdyc, u, usol), max_err(ebdyc, v, vsol)]
    vel_err = max(max(a) for a in vel)
    shift = float((p.grid.cpu().numpy() - psol(grid.xg, grid.yg))
                  [ebdyc.phys].mean())
    p_err = max(max_err(ebdyc, p, psol, shift))
    iters = stats["annular_iterations"][0]
    resid = stats["annular_residuals"][0]
    print(f"# stokes solve: first {first_s * 1e3:.1f} ms, warm median "
          f"{statistics.median(warm) * 1e3:.1f} ms "
          f"(runs {', '.join(f'{w * 1e3:.1f}' for w in warm)} ms), "
          f"{iters} GMRES iterations, residual {resid:.3e}, velocity error "
          f"{vel_err:.4e} (u grid {vel[0][0]:.3e} radial {vel[0][1]:.3e}, "
          f"v grid {vel[1][0]:.3e} radial {vel[1][1]:.3e}), pressure error "
          f"{p_err:.3e} (mean shift {shift:.3e}), launches {launches}",
          flush=True)
    if not (math.isfinite(vel_err) and vel_err < TOL_STOKES_VEL):
        raise RuntimeError(f"stokes velocity error {vel_err:.4e} >= "
                           f"{TOL_STOKES_VEL}")
    if not (math.isfinite(p_err) and p_err < TOL_STOKES_P):
        raise RuntimeError(f"stokes pressure error {p_err:.3e} >= "
                           f"{TOL_STOKES_P}")
    if not resid <= GMRES_TOL:
        raise RuntimeError(f"annular Stokes GMRES residual {resid:.3e} > "
                           f"{GMRES_TOL}")
    if launches["stokes_slp"] <= 0:
        raise RuntimeError("the Stokes solve launched no stokes_slp kernel")
    print("# stokes annular GMRES alone (maxiter 100, restart 30): "
          + "; ".join(f"tol {t:.0e}: {i} iterations, true residual {r:.3e}"
                      for t, i, r in gmres_floor(solver, fu, fv)), flush=True)
    print(f"# stokes phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    bnd, by = bound_ms("stokes_slp", S, T_merged)
    return {"name": "stokes_slp", "route": "cuda",
            "source": "ipde_tpu_torch/csrc/stokes_slp.cu",
            "replaces": "ipde_tpu/ops/pallas_ds.py:510",
            "launches": launches["stokes_slp"], "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def main():
    t_start = time.perf_counter()
    # ---- phase 1: device, card, build ------------------------------------
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import kernels as K
    from ipde_tpu_torch.ops import stokes_kernels as SK

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for lib in [pool.submit(K.load_library), pool.submit(SK.load_library)]:
            lib.result()
    print(f"# build laplace_slp.cu + stokes_slp.cu: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counters = {"laplace_slp": K.laplace_slp_apply,
                "stokes_slp": SK.stokes_slp_apply}

    # ---- phases 2 and 3: each main path, its kernels held to the plain ---
    kernels = [poisson_phase(dev, K, counters),
               stokes_phase(dev, SK, counters)]

    # ---- phase 4: results --------------------------------------------------
    print(f"# total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
