"""GPU smoke run of the ipde_tpu_torch port: the quickest proof that the port
builds and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed; each
phase prints its seconds):
  1. require a CUDA device; print the card's name and power limit; build the
     four CUDA kernels from ``ipde_tpu_torch/csrc`` (one nvcc per source,
     started together) and print the build seconds.
  2. Poisson: compare the Laplace single-layer kernel with its plain torch
     version on near-coincident test clouds and at the shapes of the Poisson
     solve (max relative difference <= 1e-12), and the Laplace gradient
     kernel on the clouds and at the merged shape with the solve's own
     merged sigma_g as charges (relative to max(1, |gx| + |gy|) per row,
     <= 1e-12; no solver calls the gradient); run the interior Poisson
     Dirichlet solve of the reference paper's refinement row,
     star(1200, a=0.2, f=3), M=16, qfs_tolerance=1e-14 (a 544x576 box grid,
     201,824 dof), through PoissonSolver.solve_with_stats +
     DirichletBIE.apply_bc; require max error < 2.5e-11 against the
     analytic solution, an annular GMRES residual <= tol, and laplace_slp
     launches from that run.  Both Laplace kernels are also held to their
     plain versions at the BIE-grid and one radial-group shape and on the
     edge clouds below, and timed alone (the single layer at the six
     recorded launches of one solve, the gradient at the merged and one
     radial-group shape) beside the bound, each launch run twice with
     bit-equal outputs.
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
  4. modified Helmholtz: compare the Yukawa kernel with its plain torch
     version on the clouds for k = 1 and k = 20 and at the merged, BIE-grid
     and one radial-group shape of each problem (<= 1e-12 relative to
     max|plain|); run two interior Yukawa solves through
     ModifiedHelmholtzSolver.solve_with_stats and a BIE's apply_bc, with
     the manufactured solution of tests/test_interior_mh.py:
       - mh_dirichlet_k2: k = 2, star(800, a=0.2, f=5), M=20,
         qfs_tolerance=1e-14 (tests/test_interior_mh.py), DirichletBIE;
         error < 2.5e-10, that test's assert;
       - mh_neumann_k2e4: k = 100 (k^2 = 1e4), star(600, a=0.2, f=5), M=24,
         qfs_tolerance=1e-14, the reference paper's high-k Neumann row
         (examples/mh_neumann_refinement.py), NeumannBIE; error < 4.10e-9,
         the reference's converged value;
     each also requires an annular GMRES residual <= tol and mh_slp
     launches from its run.
  5. print the kernels' JSON line, the card's name and power limit, then
     the device JSON line last.
The Stokeslet and Yukawa kernels are also (phases 3 and 4, on lines of their
own): timed alone at all six launch shapes of their problem beside the bound,
each launch run twice with bit-equal outputs.  Every kernel is compared with
its plain version on clouds on either side of the threshold below which its
launcher splits the sources across blocks, and on one whose T and S are
multiples of no tile; the
Yukawa kernel on a box-grid cloud at k = 100 in spatial order (most source
tiles skipped), row-major and shuffled.  The kernels' device log, exp,
reciprocal and reciprocal square root (csrc/fp64_math.cuh) are held to
torch's on 1e6 values of r^2 over [1e-30, 1e3], values within 1e-8 of 1 among
them.

Each main path runs with every kernel's launch count set to 0 just before
it and read just after; the comparisons with the plain versions are not
counted.  ``bound_ms`` is the larger of the bytes the function must move
(each input read once, each output written once) over 3.35 TB/s and its
FP64 operations over 34 TFLOP/s, the H100 SXM's FP64 peak outside the
tensor cores (NVIDIA H100 data sheet); operations are counted per
target-source pair from each kernel's code with an FMA as two and a log,
exp, sqrt or reciprocal as one.  The Yukawa kernel's work depends on the
data: each pair takes one branch of its K0 by z = k r, so its operations are
counted per branch and weighted by the pairs of the timed inputs that fall
in each (counted on the card with the plain code's z).
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
# (name, k, nb, M, BIE, error limit): the modified Helmholtz problems
MH_CASES = (
    ("mh_dirichlet_k2", 2.0, 800, 20, "dirichlet", 2.5e-10),
    ("mh_neumann_k2e4", 100.0, 600, 24, "neumann", 4.10e-9),
)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# FP64 operations per target-source pair (FMA = 2, log = reciprocal = 1).
# These counts are frozen at the first version of each kernel, so that the
# bound reads the same work whatever implements it; the instructions a later
# version really issues are in PERF.md:
# laplace: 2 sub, r^2 (mul + FMA), max, log, FMA accumulate
# stokes: 2 sub, r^2 (mul + FMA), max, reciprocal, log, mul, the force
#         projection (mul + FMA + mul), two FMA pairs into u and v, add to p
# laplace_grad: 2 sub, r^2 (mul + FMA), max, reciprocal, mul, two FMAs
OPS_PER_PAIR = {"laplace_slp": 9, "stokes_slp": 22, "laplace_grad": 12}
# mh_slp per branch of K0 (the first csrc/mh_slp.cu; frozen likewise): every
# pair pays 2 sub, r^2 (mul + FMA), max, sqrt, mul by k, the compare z < 2
# and the FMA accumulate (11);
# series (z < 2): q (mul), 13 terms of (2 mul, add, FMA), log, 2 FMA (+71);
# Chebyshev (2 <= z <= 36): the compare z > 36, reciprocal, FMA, add, 25
# Clenshaw steps of (sub, FMA), the last (sub, FMA), exp, sqrt, 2 mul
# (+87); dead (z > 36): the compare (+1)
MH_OPS_PER_PAIR = {"series": 82, "cheb": 98, "dead": 12}


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


# the manufactured solution of tests/test_interior_mh.py and test_neumann.py
def mh_sol(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y) + 0.3 * np.cos(3 * x) * np.cos(y)


def mh_lap_sol(x, y):
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    u2 = 0.3 * np.cos(3 * x) * np.cos(y)
    return u1xx - 4 * u1 - 10 * u2


def mh_grad_sol(x, y):
    ux = (np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y)
          - 0.9 * np.sin(3 * x) * np.cos(y))
    uy = 2 * np.exp(np.sin(x)) * np.cos(2 * y) - 0.3 * np.cos(3 * x) * np.sin(y)
    return ux, uy


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


def grad_err(got, want):
    """(max abs difference, max difference relative to max(1, |gx| + |gy|)
    per row, as tests/test_pallas_ds.py measures the gradient)."""
    scale = (want[0].abs() + want[1].abs()).clamp_min(1.0)
    a = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return a, max(float(((g - w).abs() / scale).max())
                  for g, w in zip(got, want))


def stokes_err(got, want):
    """(max abs difference, max relative difference): u and v relative to
    max|u| and max|v|, p relative to max(1, |p|) per row."""
    a = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got[:2], want[:2]))
    rel = max(rel, float(((got[2] - want[2]).abs()
                          / want[2].abs().clamp_min(1.0)).max()))
    return a, rel


def bound_ms(name, S, T, ops=None):
    """The least time the card could take for one apply: see the module
    docstring.  ``ops`` defaults to OPS_PER_PAIR[name] per pair."""
    n_in, n_out = {"laplace_slp": (3, 1), "stokes_slp": (4, 3),
                   "laplace_grad": (3, 2), "mh_slp": (3, 1)}[name]
    nbytes = 8 * (n_in * S + 2 * T + n_out * T)
    if ops is None:
        ops = OPS_PER_PAIR[name] * S * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else \
        "operations"


def compare(kernel, plain, err, label, args, timed=False, plain_reps=5):
    """Kernel vs plain version on one input set (sx, sy, ..., tx, ty[, k]);
    returns (max abs diff, kernel ms, plain ms)."""
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
        plain_ms = cuda_ms(lambda: plain(*args), reps=plain_reps)
    T = next(a for a in reversed(args) if isinstance(a, torch.Tensor)).shape[0]
    print(f"# {kernel.__name__} {label}: T={T} "
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


def build_mh_problem(dev, k, nb, M, bie_kind):
    """An interior modified Helmholtz problem of MH_CASES, with the
    manufactured solution mh_sol; ``bie_kind`` "dirichlet" or "neumann"."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import DirichletBIE, NeumannBIE
    from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver

    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy], device=dev)
    grid = ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(
        ebdyc, lambda x, y: k * k * mh_sol(x, y) - mh_lap_sol(x, y))
    solver = ModifiedHelmholtzSolver(ebdyc, k=k)
    if bie_kind == "neumann":
        ux, uy = mh_grad_sol(bdy.x, bdy.y)
        bc = BoundaryFunction([torch.as_tensor(
            ux * bdy.normal_x + uy * bdy.normal_y, device=ebdyc.device)])
        bie = NeumannBIE(solver)
    else:
        bc = BoundaryFunction.from_function(ebdyc, mh_sol)
        bie = DirichletBIE(solver)
    return ebdyc, grid, f, bc, solver, bie


def mh_branch_counts(sx, sy, tx, ty, k):
    """Pairs of these inputs that take each branch of K0 (series z < 2,
    Chebyshev 2 <= z <= 36, dead z > 36), with the plain code's z, counted
    on the card in chunks."""
    from ipde_tpu_torch.ops import kernels as K
    S, T = sx.shape[0], tx.shape[0]
    n_series = n_dead = 0
    chunk = max(1, (1 << 24) // max(S, 1))
    for i0 in range(0, T, chunk):
        dx = tx[i0:i0 + chunk, None] - sx[None, :]
        dy = ty[i0:i0 + chunk, None] - sy[None, :]
        z = torch.sqrt((dx * dx + dy * dy).clamp_min_(K._MIN_R2)) * k
        n_series += int((z < K.K0_CHEB_LO).sum())
        n_dead += int((z > K.K0_CHEB_HI).sum())
    return {"series": n_series, "cheb": S * T - n_series - n_dead,
            "dead": n_dead}


def mh_divergence_share(sx, sy, tx, ty, k):
    """The share of (warp of 32 consecutive targets, source) pairs whose
    lanes fall in more than one branch of K0, for this target order, counted
    on the card in chunks of whole warps (a last short warp counts its live
    lanes only)."""
    from ipde_tpu_torch.ops import kernels as K
    S, T = sx.shape[0], tx.shape[0]
    n_warps = -(-T // 32)
    pad = n_warps * 32 - T
    if pad:         # repeat the last target: it adds no branch to its warp
        tx = torch.cat([tx, tx[-1:].expand(pad)])
        ty = torch.cat([ty, ty[-1:].expand(pad)])
    diverged = 0
    chunk = max(32, (1 << 24) // max(S, 1) // 32 * 32)
    for i0 in range(0, n_warps * 32, chunk):
        dx = tx[i0:i0 + chunk, None] - sx[None, :]
        dy = ty[i0:i0 + chunk, None] - sy[None, :]
        z = torch.sqrt((dx * dx + dy * dy).clamp_min_(K._MIN_R2)) * k
        branch = ((z >= K.K0_CHEB_LO).to(torch.int8)
                  + (z > K.K0_CHEB_HI).to(torch.int8)).reshape(-1, 32, S)
        diverged += int((branch.amin(1) != branch.amax(1)).sum())
    return diverged / (n_warps * S)


def mh_bound_ms(sx, sy, tx, ty, k):
    """bound_ms of one Yukawa apply, its operations weighted by branch;
    also returns the branch counts."""
    counts = mh_branch_counts(sx, sy, tx, ty, k)
    ops = sum(MH_OPS_PER_PAIR[b] * n for b, n in counts.items())
    return bound_ms("mh_slp", sx.shape[0], tx.shape[0], ops) + (counts,)


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


def merged_sigma_g(solver, f):
    """The merged sigma_g that one solve hands its merged layer-potential
    apply (a solve outside the counted runs)."""
    seen = []

    def grab(sigma_g, tx, ty):
        seen.append(sigma_g)
        return type(solver)._apply_merged(solver, sigma_g, tx, ty)

    solver._apply_merged = grab
    try:
        solver.solve_with_stats(f, tol=GMRES_TOL, maxiter=100, restart=30)
    finally:
        del solver._apply_merged
    return seen[0]


def record_launch_args(run, module, name):
    """Run ``run`` once with ``module.name`` wrapped to keep the arguments of
    each call; returns them.  The wrapper counts its launches in the
    attribute of its module-level name, so the stand-in carries it."""
    orig = getattr(module, name)
    calls = []

    def wrapped(*args):
        calls.append(args)
        return orig(*args)

    wrapped.launches = orig.launches
    setattr(module, name, wrapped)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
        orig.launches = wrapped.launches
    return calls


def time_launches(label, kernel, calls, bound_of, what="launches of one solve"):
    """The kernel alone at each of ``calls`` (the recorded launches of one
    solve): its time beside its bound, and two runs on the same input bit
    for bit."""
    total = 0.0
    for i, args in enumerate(calls):
        a, b = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        a, b = (o if isinstance(o, tuple) else (o,) for o in (a, b))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"{label} launch {i}: two runs on one input "
                               "differ")
        ms = cuda_ms(lambda: kernel(*args), reps=10)
        total += ms
        bnd, by = bound_of(*args)[:2]
        T = next(t for t in reversed(args)
                 if isinstance(t, torch.Tensor)).shape[0]
        print(f"# {label} launch {i}: T={T} S={args[0].shape[0]} kernel "
              f"{ms:.4f} ms, bound {bnd:.4f} ms ({by}), two runs bit-equal",
              flush=True)
    print(f"# {label}: {total:.4f} ms of kernel in the {len(calls)} {what}",
          flush=True)


# (T, S) on either side of the threshold below which each launcher splits the
# sources across blocks (laplace_slp, laplace_grad and stokes_slp: 528 blocks
# of 256 targets, T <= 67,584; mh_slp: 2,112 blocks, T <= 270,336), and one
# whose T and S are multiples of no tile
EDGE_SHAPES = {"laplace_slp": ((67584, 300), (67585, 300), (8193, 1023)),
               "laplace_grad": ((67584, 300), (67585, 300), (8193, 1023)),
               "stokes_slp": ((67584, 300), (67585, 300), (8193, 1023)),
               "mh_slp": ((270336, 300), (270337, 300), (8193, 1023))}


def grid_cloud(n=256, S=600, seed=3):
    """An n x n box grid on [-1.5, 1.5]^2 (row-major) around S sources on a
    star-like curve of radius ~1, and its spacing: (sx, sy, q, tx, ty), h."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(S) / S
    rad = 1.0 + 0.2 * np.cos(5 * th)
    g = np.linspace(-1.5, 1.5, n)
    tx, ty = (a.ravel().copy() for a in np.meshgrid(g, g, indexing="ij"))
    return (rad * np.cos(th), rad * np.sin(th), rng.standard_normal(S) / S,
            tx, ty), 3.0 / (n - 1)


def device_math_check(dev, SK):
    """csrc/fp64_math.cuh on the card against torch: log to 4e-16
    max(1, |log|); reciprocal, reciprocal square root and exp of the negated
    argument (capped at -700) to 2e-15 relative."""
    rng = np.random.default_rng(13)
    a = torch.as_tensor(np.concatenate(
        [10.0 ** rng.uniform(-30, 3, 900_000),
         1.0 + rng.uniform(-1e-8, 1e-8, 99_997), [1.0, 1e-30, 1e3]]),
        device=dev)
    lg, rc, rs, ex = SK.fp64_math_probe(a)
    want = torch.log(a)
    e_log = float(((lg - want).abs() / want.abs().clamp_min(1.0)).max())
    e_rcp = float((rc * a - 1.0).abs().max())
    e_rsq = float((rs * rs * a - 1.0).abs().max())
    want = torch.exp(-a.clamp_max(700.0))
    e_exp = float(((ex - want).abs() / want).max())
    print(f"# device math on {a.numel()} values of r^2 in [1e-30, 1e3]: log "
          f"max |err| / max(1, |log|) {e_log:.3e} (limit 4e-16), reciprocal "
          f"{e_rcp:.3e}, reciprocal square root {e_rsq:.3e}, exp(-r^2) "
          f"{e_exp:.3e} (relative, limit 2e-15)", flush=True)
    if not (e_log <= 4e-16 and max(e_rcp, e_rsq, e_exp) <= 2e-15):
        raise RuntimeError("the device math disagrees with torch")


def poisson_phase(dev, K, counters):
    t_phase = time.perf_counter()
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    lap = (K.laplace_slp_apply, K.laplace_slp_apply_plain, laplace_err)
    grad = (K.laplace_slp_grad_apply, K.laplace_slp_grad_apply_plain,
            grad_err)
    errs = []
    grad_errs = []
    for seed in (0, 4):
        sx, sy, q, _, tx, ty = map(as_dev, cloud(seed=seed))
        errs.append(compare(*lap, f"cloud seed {seed}",
                            (sx, sy, q, tx, ty))[0])
    for seed in (1, 4):
        sx, sy, q, _, tx, ty = map(as_dev, cloud(seed=seed))
        grad_errs.append(compare(*grad, f"cloud seed {seed}",
                                 (sx, sy, q, tx, ty))[0])
    for name, fns, into in (("laplace_slp", lap, errs),
                            ("laplace_grad", grad, grad_errs)):
        for T, S in EDGE_SHAPES[name]:
            sx, sy, q, _, tx, ty = map(as_dev, cloud(T, S, seed=6))
            into.append(compare(
                *fns, f"cloud {K.split_count(name, T, S)} source range(s)",
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
    bie_grid = (src["x"], src["y"], q[:src["x"].shape[0]].contiguous(),
                bie.phys_x, bie.phys_y)
    f0, tx, ty, gsx, gsy, gw = bie.radial_plans[0][0].groups[0]
    radial = (gsx, gsy, gw, tx, ty)
    for fns, into in ((lap, errs), (grad, grad_errs)):
        into.append(compare(*fns, "BIE source -> physical grid",
                            bie_grid)[0])
        into.append(compare(*fns, f"BIE source -> radial rows (stride {f0})",
                            radial)[0])

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
    # the gradient at the merged shape, charged with the solve's own sigma_g
    gq = merged_sigma_g(solver, f) * solver.grid_src_w
    grad_merged = (solver.grid_src_x, solver.grid_src_y, gq,
                   solver._dense_tx, solver._dense_ty)
    ge, gms, gplain_ms = compare(
        *grad, "merged sigma_g -> pna+interface", grad_merged, timed=True)
    grad_errs.append(ge)
    # each kernel alone: the single layer at the six launches of one solve,
    # the gradient (no solver calls it) at the merged and a radial shape
    time_launches("laplace_slp", K.laplace_slp_apply,
                  record_launch_args(run, K, "laplace_slp_apply"),
                  lambda sx, sy, w, tx, ty: bound_ms(
                      "laplace_slp", sx.shape[0], tx.shape[0]))
    time_launches("laplace_grad", K.laplace_slp_grad_apply,
                  [grad_merged, radial],
                  lambda sx, sy, w, tx, ty: bound_ms(
                      "laplace_grad", sx.shape[0], tx.shape[0]),
                  what="launches above (merged, radial)")
    print(f"# poisson phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    T = merged[3].shape[0]
    bnd, by = bound_ms("laplace_slp", S, T)
    gbnd, gby = bound_ms("laplace_grad", S, T)
    return [{"name": "laplace_slp", "route": "cuda",
             "source": "ipde_tpu_torch/csrc/laplace_slp.cu",
             "replaces": "ipde_tpu/ops/pallas_ds.py:469",
             "launches": launches["laplace_slp"], "max_abs_err": max(errs),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
             "bound_by": by, "library_ms": None},
            {"name": "laplace_grad", "route": "cuda",
             "source": "ipde_tpu_torch/csrc/laplace_grad.cu",
             "replaces": "ipde_tpu/ops/pallas_ds.py:479",
             "launches": launches["laplace_grad"],
             "max_abs_err": max(grad_errs), "ms": gms,
             "plain_ms": gplain_ms, "bound_ms": gbnd, "bound_by": gby,
             "library_ms": None}]


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
    device_math_check(dev, SK)
    errs = [compare(*sto, f"cloud seed {seed}",
                    tuple(map(as_dev, cloud(seed=seed))))[0]
            for seed in (2, 5)]
    from ipde_tpu_torch.ops.kernels import split_count
    for T, S in EDGE_SHAPES["stokes_slp"]:
        errs.append(compare(
            *sto, f"cloud {split_count('stokes_slp', T, S)} source range(s)",
            tuple(map(as_dev, cloud(T, S, seed=6))))[0])

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
    time_launches("stokes_slp", SK.stokes_slp_apply,
                  record_launch_args(run, SK, "stokes_slp_apply"),
                  lambda sx, sy, wfx, wfy, tx, ty: bound_ms(
                      "stokes_slp", sx.shape[0], tx.shape[0]))
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


def mh_phase(dev, K, counters):
    t_phase = time.perf_counter()
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    mh = (K.mh_slp_apply, K.mh_slp_apply_plain, laplace_err)
    errs = []
    for k in (1.0, 20.0):
        sx, sy, q, _, tx, ty = map(as_dev, cloud(seed=5))
        errs.append(compare(*mh, f"cloud seed 5, k={k:g}",
                            (sx, sy, q, tx, ty, k))[0])
    for T, S in EDGE_SHAPES["mh_slp"]:
        sx, sy, q, _, tx, ty = map(as_dev, cloud(T, S, seed=6))
        errs.append(compare(
            *mh, f"cloud {K.split_count('mh_slp', T, S)} source range(s), "
            "k=20", (sx, sy, q, tx, ty, 20.0))[0])
    # any target order is right; in spatial order at k = 100 most (warp,
    # 32-source) tiles are out of reach and skipped
    (sx, sy, q, tx, ty), h = grid_cloud()
    sx, sy, q, tx, ty = map(as_dev, (sx, sy, q, tx, ty))
    orders = {"row-major": torch.arange(tx.shape[0], device=dev),
              "spatial order": K.spatial_order(tx, ty, cell=h),
              "shuffled": as_dev(np.random.default_rng(4).permutation(
                  tx.shape[0]))}
    for label, perm in orders.items():
        args = (sx, sy, q, tx[perm].contiguous(), ty[perm].contiguous(), 100.0)
        errs.append(compare(*mh, f"grid cloud, k=100, {label}", args,
                            timed=True, plain_reps=1)[0])
        print(f"#   {label}: pairs by branch "
              f"{mh_branch_counts(*args[:2], *args[3:])}, warp-source pairs "
              "in more than one branch "
              f"{mh_divergence_share(*args[:2], *args[3:]):.4f}", flush=True)
    entry = None
    total_launches = 0
    for name, k, nb, M, bie_kind, limit in MH_CASES:
        t0 = time.perf_counter()
        ebdyc, grid, f, bc, solver, bie = build_mh_problem(dev, k, nb, M,
                                                           bie_kind)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        e0 = ebdyc.ebdys[0]
        dof = int(ebdyc.phys.sum() + np.prod(e0.radial_shape))
        n_pna = ebdyc.pna_x.size
        T_merged = solver._dense_tx.shape[0]
        S = solver.grid_src_x.shape[0]
        print(f"# {name} setup {setup_s:.2f} s: k={k:g}, grid {grid.shape}, "
              f"{dof} dof, {n_pna} pna + {T_merged - n_pna} interface = "
              f"{T_merged} merged targets, {S} merged QFS sources, "
              f"{bie.phys_x.shape[0]} physical points, QFS shift alpha "
              f"{solver._qfs_alpha(e0):.4f}", flush=True)

        rng = np.random.default_rng(7)
        q = as_dev(rng.standard_normal(S) / S)
        merged = (solver.grid_src_x, solver.grid_src_y, q, solver._dense_tx,
                  solver._dense_ty, k)
        e, ms, plain_ms = compare(*mh, f"{name} merged sigma_g -> "
                                  "pna+interface", merged, timed=True,
                                  plain_reps=2)
        errs.append(e)
        bnd, by, counts = mh_bound_ms(*merged[:2], *merged[3:])
        print(f"# mh_slp_apply {name} merged: pairs by branch {counts}, "
              f"bound {bnd:.4f} ms ({by}), warp-source pairs in more than "
              f"one branch {mh_divergence_share(*merged[:2], *merged[3:]):.4f}",
              flush=True)
        src = bie.src_list[0].dev(dev)
        n = src["x"].shape[0]
        errs.append(compare(*mh, f"{name} BIE source -> physical grid",
                            (src["x"], src["y"], q[:n].contiguous(),
                             bie.phys_x, bie.phys_y, k))[0])
        f0, tx, ty, gsx, gsy, gw = bie.radial_plans[0][0].groups[0]
        errs.append(compare(*mh, f"{name} BIE source -> radial rows "
                            f"(stride {f0})", (gsx, gsy, gw, tx, ty, k))[0])

        def run():
            ue, stats = solver.solve_with_stats(f, tol=GMRES_TOL, maxiter=100,
                                                restart=30)
            ue = bie.apply_bc(ue, bc)
            torch.cuda.synchronize()
            return ue, stats

        (ue, stats), launches, first_s, warm = timed_runs(run, counters)
        grid_err, rad_err = max_err(ebdyc, ue, mh_sol)
        err = max(grid_err, rad_err)
        iters = stats["annular_iterations"][0]
        resid = stats["annular_residuals"][0]
        print(f"# {name} solve: first {first_s * 1e3:.1f} ms, warm median "
              f"{statistics.median(warm) * 1e3:.1f} ms "
              f"(runs {', '.join(f'{w * 1e3:.1f}' for w in warm)} ms), "
              f"{iters} GMRES iterations, residual {resid:.3e}, max error "
              f"{err:.3e} (grid {grid_err:.3e}, radial {rad_err:.3e}; limit "
              f"{limit:.3g}), launches {launches}", flush=True)
        if not (math.isfinite(err) and err < limit):
            raise RuntimeError(f"{name} error {err:.3e} >= {limit}")
        if not resid <= GMRES_TOL:
            raise RuntimeError(f"{name} annular GMRES residual {resid:.3e} "
                               f"> {GMRES_TOL}")
        if launches["mh_slp"] <= 0:
            raise RuntimeError(f"the {name} solve launched no mh_slp kernel")
        time_launches(f"mh_slp {name}", K.mh_slp_apply,
                      record_launch_args(run, K, "mh_slp_apply"),
                      lambda sx, sy, w, tx, ty, k: mh_bound_ms(sx, sy, tx, ty,
                                                               k))
        total_launches += launches["mh_slp"]
        if entry is None:      # the kernels line times the k = 2 merged apply
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by}
    print(f"# mh phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"name": "mh_slp", "route": "cuda",
            "source": "ipde_tpu_torch/csrc/mh_slp.cu",
            "replaces": "ipde_tpu/ops/pallas_ds.py:495",
            "launches": total_launches, "max_abs_err": max(errs), **entry,
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
    loaders = (K.load_library, K.load_grad_library, K.load_mh_library,
               SK.load_library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for lib in [pool.submit(fn) for fn in loaders]:
            lib.result()
    print(f"# build laplace_slp.cu + laplace_grad.cu + mh_slp.cu + "
          f"stokes_slp.cu (all four with fp64_math.cuh): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counters = {"laplace_slp": K.laplace_slp_apply,
                "laplace_grad": K.laplace_slp_grad_apply,
                "mh_slp": K.mh_slp_apply,
                "stokes_slp": SK.stokes_slp_apply}

    # ---- phases 2-4: each main path, its kernels held to the plain -------
    kernels = [*poisson_phase(dev, K, counters),
               stokes_phase(dev, SK, counters),
               mh_phase(dev, K, counters)]

    # ---- phase 5: results --------------------------------------------------
    print(f"# total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
