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
  5. multi-body (several boundaries and inclusions), on one collection per
     problem with both grid backends (dense, then fft):
       - stokes_3body: examples/stokes_refinement.py::run_case(700, 16), the
         outer star(700, a=0.1, f=3), M=16, and two star inclusions of 350
         points, M=10, through StokesSolver + StokesDirichletBIE; velocity
         error over the physical grid and every radial grid <=
         TOL_STOKES3_VEL (3 x ipde_tpu's own CPU error on this case, see
         IPDE_TPU_STOKES3_CPU), printed beside the example's rule against the
         reference paper's row (TOL_STOKES3_PAPER);
       - mh_3body_k2: the three-body Yukawa problem of
         tests/test_multi_body.py (k = 2, nb = 200, M = 10, DirichletBIE);
         error < 5e-9, that test's assert;
       - poisson_inclusion: the Poisson problem with one inclusion of
         tests/test_exterior.py (nb 300 + 200, M = 10, DirichletBIE); error
         < 5e-8, that test's assert;
     each with annular residuals <= tol, kernel launches, the timing lines of
     the other phases, and for the fft run every launch of one solve +
     apply_bc recorded: each distinct (T, S) against the plain version and
     timed beside its bound, two runs bit for bit.  Then the lockstep
     GMRES on the card (batched_stokes_solve on the two inclusions of
     stokes_3body, batched_annular_solve on those of mh_3body_k2) against
     the per-boundary loop: within 1e-10, iterations within one, residuals
     <= tol, both timed.
  6. the moving-boundary path:
       - stepper: examples/coupled_advection_diffusion.py at its defaults,
         star(200, a=0.1, f=3), M=10, generate_grid(bh, pad_quantum=2048),
         nu = 0.05, dt = 0.05 (k = 20), the rigid rotation u = -y, v = x,
         4 steps of CoupledAdvectionDiffusionStepper (GMRES tol 1e-12),
         every count set to 0 before step 1 and read after step 4; each
         step's generate / advect / setup / solve seconds and mh_slp
         launches; step 2 traced by torch.profiler (device ms, idle share);
         the mh_slp launches of step 3 recorded and, after the run, each
         distinct (T, S) held to the plain version (<= 1e-12 relative),
         timed beside its bound, two runs bit for bit; the relative error
         against the exact solution must be within 1e-8 of ipde_tpu's on
         the CPU (IPDE_TPU_COUPLED_CPU); the final mass is printed;
       - advectors: examples/unsteady_advection_study.py at dt = 0.05 to
         T = 0.4 (circle(150), M=12), FE, BDF2 and BDF3, each error within
         1% of ipde_tpu's on the CPU (IPDE_TPU_UNSTEADY_CPU);
       - tier-2 interface plan: bench.py tier 2's geometry and box
         (star(2700, a=0.2, f=5), M=20, grid_target 2048); generate_grid
         must route the interface plan to PeriodicInterpolator2D, whose
         values and window derivatives for one smooth field must be within
         1e-12 (of the field's max) of ExactInterp2D on the same targets;
         both timed.
  7. solver_type="fourth", the periodic evaluator and the example scripts:
       - fourth-order Poisson on phase 2's collection (PoissonSolver(...,
         solver_type="fourth"), fft grid backend, DirichletBIE): error
         within 1% (either side) of ipde_tpu's CPU error on the same
         problem (IPDE_TPU_FOURTH_CPU, from
         tools/ipde_tpu_fourth_reference.py) and < 5e-6 (tests/test_collection_calculus.py:97), residual <= tol,
         laplace_slp launches; the timing lines of the other phases with
         phase 2's spectral error beside them; every distinct launch held
         to the plain version, timed, two runs bit for bit;
       - fourth-order Stokes on phase 5's stokes_3body collection: velocity
         error within 1% of ipde_tpu's CPU error with the port's BIE radial
         plans and < 2e-5 (tests/test_collection_calculus.py:123),
         stokes_slp launches, the same lines and holds;
       - the periodic evaluator on a 1024 x 1024 grid of [0, 2 pi]^2, 3,600
         sources on a star and 16 within r_cut of an edge or a corner:
         Yukawa (kappa = 20) against the mh_slp sum over 3 x 3 image shifts
         at every grid point farther than 6 h from every source, Laplace
         (non-neutral and neutral charges) against an independent Ewald sum
         at 240 such points, absolute error <= 1e-9 (the limit of
         tests/test_periodic_grid_eval.py), two runs bit for bit; setup and
         the apply's median of 10 beside a FreespaceGridEvaluator's;
       - the smallest default row of examples/torch_poisson_refinement.py
         (200, 8), torch_mh_neumann_refinement.py (k = 1: 200, 10),
         torch_advection_convergence.py (dt = 0.1, nb = 200, M = 10,
         T = 0.2; FE and BDF2) through their own run_case on the card,
         and torch_stokes_refinement.py (100, 8) with its REFERENCE_ERR
         rule, each within 1% of ipde_tpu's CPU value
         (IPDE_TPU_EXAMPLES_CPU; for the Stokes row ipde_tpu with the
         port's BIE radial plans); the LEDGER_TPU.json rows printed beside
         them; they record nothing;
       - ipde_tpu_torch.entry.entry(): one fn(*args) on the card, its error
         against the analytic solution < 2e-6;
       every launch of each example run and of entry() recorded and, after
       the run, each distinct (T, S) held to the plain version (<= 1e-12
       relative), timed beside its bound, two runs bit for bit.
     Each solve of the phase runs with every count set to 0 just before it
     and read just after; its launches join the kernels' JSON line.
  8. print the kernels' JSON line, the card's name and power limit, then
     the device JSON line last.
The four solves above run with grid_backend="dense": the merged sigma_g and
the BIE field go onto the physical grid points through the CUDA kernels.
Then the Poisson, Stokes and k = 2 Yukawa problems run again on the same
collection with the solvers' default grid_backend="fft" (the free-space FFT
evaluators of ipde_tpu_torch/ops/grid_eval.py; the k = 100 Neumann problem,
whose host setup alone is over a minute, stays dense-only): both evaluators
of each (the solver's merged sigma_g, the BIE's) are held to the dense CUDA
kernel at every physical point, max |fft - dense| / max(1, max|dense|) <=
1e-12 (Laplace, Yukawa), 1e-10 (velocity) and 1e-11 (pressure), with two
runs compared bit for bit and each timed beside the dense apply it
replaces; each fft solve must meet its problem's error limit, residual and
kernel launches.  For both backends each problem prints, from this run: the
setup seconds, the first solve, the warm solve's median of WARM_RUNS runs
with min and max, and the device time per solve and idle share of 3 solves
traced by torch.profiler.
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

Each main path (each problem, each backend) runs with every kernel's launch
count set to 0 just before it and read just after; a kernel's ``launches``
in the JSON line is the sum over its main-path runs; the comparisons with
the plain versions and the dense kernel are not counted.  ``bound_ms`` is the larger of the bytes the function must move
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
import os
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
WARM_RUNS = 10
# (name, k, nb, M, BIE, error limit): the modified Helmholtz problems
MH_CASES = (
    ("mh_dirichlet_k2", 2.0, 800, 20, "dirichlet", 2.5e-10),
    ("mh_neumann_k2e4", 100.0, 600, 24, "neumann", 4.10e-9),
)
# the multi-body phase: examples/stokes_refinement.py::run_case(700, 16); the
# example's rule (3 x the reference paper's row at nb=700), and ipde_tpu's
# own error on this very case on the CPU, as shipped and with the BIE radial
# plans of the port (tools/ipde_tpu_three_body_stokes.py); the port is held
# to 3 x the latter, the example's rule against ipde_tpu on this case
STOKES3_NB, STOKES3_M = 700, 16
TOL_STOKES3_PAPER = 3 * 3.3441e-10
IPDE_TPU_STOKES3_CPU = {"ipde_tpu": 7.141975137070489e-06,
                        "port": 6.322489587429203e-09}
TOL_STOKES3_VEL = 3 * IPDE_TPU_STOKES3_CPU["port"]
MH3_K = 2.0
TOL_MH3 = 5e-9                   # tests/test_multi_body.py
TOL_INCLUSION = 5e-8             # tests/test_exterior.py
# the stepper phase: examples/coupled_advection_diffusion.py at its defaults
# (4 steps); ipde_tpu's relative error and final mass on the CPU, from
#   JAX_PLATFORMS=cpu python tools/ipde_tpu_advection_reference.py --cases coupled
# (the example itself prints "rel err 2.05e-02 after T=0.2" and "final mass:
# 1.009941510172469"); the port is held to that error within 1e-8 absolute
ADV_NB, ADV_M, ADV_PQ, ADV_STEPS = 200, 10, 2048, 4
ADV_NU, ADV_DT, ADV_T0 = 0.05, 0.05, 0.5
IPDE_TPU_COUPLED_CPU = {"rel_err": 0.020508347002549318,
                        "mass": 1.009941510172469}
TOL_COUPLED_ABS = 1e-8
# the advector phase: examples/unsteady_advection_study.py at dt = 0.05 to
# T = 0.4 (circle(150), M = 12); ipde_tpu's errors on the CPU from
#   JAX_PLATFORMS=cpu python tools/ipde_tpu_advection_reference.py --cases unsteady
# (LEDGER_TPU.json unsteady_advection@cpu: 2.4424e-2, 3.5844e-3, 2.4272e-4);
# the port is held to each within 1% relative
UNSTEADY_NB, UNSTEADY_M, UNSTEADY_DT, UNSTEADY_T = 150, 12, 0.05, 0.4
IPDE_TPU_UNSTEADY_CPU = {"fe": 0.02442428590669099,
                         "bdf2": 0.003584412448387919,
                         "bdf3": 0.0002427203155279667}
TOL_UNSTEADY_REL = 0.01
# the tier-2 interface plan: bench.py tier 2 (star(2700, a=0.2, f=5), M=20,
# h sized for grid_target 2048 as bench.py:63-71 does)
TIER2_NB, TIER2_M, TIER2_GRID_TARGET = 2700, 20, 2048
TOL_INTERFACE_REL = 1e-12
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
# phase 7: ipde_tpu's errors on the CPU, unrounded, from
#   JAX_PLATFORMS=cpu python tools/ipde_tpu_fourth_reference.py
# solver_type="fourth" on phase 2's Poisson problem and on phase 5's
# stokes_3body (with the port's BIE radial plans); the port is held to
# each within 1% (either side) and below the asserts of
# tests/test_collection_calculus.py:97, 123
IPDE_TPU_FOURTH_CPU = {"poisson": 1.905043139904805e-08,
                       "stokes_3body": 2.4820868565339493e-07}
TOL_FOURTH_REL = 0.01
TOL_FOURTH = {"poisson": 5e-6, "stokes_3body": 2e-5}
# the smallest default row of four example scripts (same tool, --cases
# examples: three through their own run_case, stokes_refinement's (100, 8)
# with the port's BIE radial plans); the port is held to each within 1%
IPDE_TPU_EXAMPLES_CPU = {"poisson_refinement": 2.8318152933692886e-08,
                         "mh_neumann_refinement": 9.958260460685153e-08,
                         "advection_convergence_fe": 0.01295928864308804,
                         "advection_convergence_bdf2": 0.008691227226839793,
                         "stokes_refinement": 1.3272890538151838e-05}
TOL_EXAMPLE_REL = 0.01
# the periodic evaluator: a 1024 x 1024 grid of [0, 2 pi]^2, 3,600 sources
# on a star plus 16 within r_cut of an edge or a corner; Yukawa at kappa =
# 20 against the mh_slp sum over 3 x 3 image shifts, Laplace against an
# independent Ewald sum; absolute limit of tests/test_periodic_grid_eval.py
PERIODIC_N, PERIODIC_S, PERIODIC_KAPPA = 1024, 3600, 20.0
TOL_PERIODIC = 1e-9
# what earlier phases leave for phase 7 to reuse (collections, errors)
SHARED = {}


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


def build_problem(dev, nb=1200, M=16, backend="fft"):
    """The Poisson problem of the reference paper's refinement row, solved
    with grid backend ``backend``."""
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
    solver = PoissonSolver(ebdyc, grid_backend=backend)
    bie = DirichletBIE(solver)
    return ebdyc, grid, f, bc, solver, bie


def build_stokes_problem(dev=None, nb=1200, M=16, grid_target=1024,
                         backend="fft"):
    """bench.py's Stokes problem (tier 1 at the defaults): h as bench.py
    sizes it for grid_target; the collection on ``dev`` (None: the card),
    solved with grid backend ``backend``."""
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
    solver = StokesSolver(ebdyc, grid_backend=backend)
    bie = StokesDirichletBIE(solver)
    return ebdyc, grid, (fu, fv), bcs, solver, bie


def build_mh_problem(dev, k, nb, M, bie_kind, backend="fft"):
    """An interior modified Helmholtz problem of MH_CASES, with the
    manufactured solution mh_sol; ``bie_kind`` "dirichlet" or "neumann";
    grid backend ``backend``."""
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
    solver = ModifiedHelmholtzSolver(ebdyc, k=k, grid_backend=backend)
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
    read just after, then WARM_RUNS warm runs; returns (result, launches by
    kernel, first s, warm s list)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = run()
    first = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        run()
        warm.append(time.perf_counter() - t0)
    return out, launches, first, warm


def warm_text(warm):
    """'median ms (min, max, n runs)' of warm run seconds."""
    ms = [w * 1e3 for w in warm]
    return (f"{statistics.median(ms):.1f} ms (min {min(ms):.1f}, max "
            f"{max(ms):.1f}, {len(ms)} runs)")


def profile_device(run, reps=3):
    """``reps`` runs traced by torch.profiler: (wall ms per run, device
    kernel ms per run, idle share of the traced window)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 1e-3 * sum(e.device_time_total for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return wall / reps, busy / reps, 1.0 - busy / wall


def report_backend(label, backend, setup_s, first_s, warm, run):
    """One line per backend of one problem, in one format: setup, first
    and warm solve, and the profiled device time and idle share."""
    wall, busy, idle = profile_device(run)
    print(f"# {label} [{backend}]: setup {setup_s:.2f} s, first solve "
          f"{first_s * 1e3:.1f} ms, warm {warm_text(warm)}; profiled "
          f"(3 solves, profiler on): wall {wall:.3f} ms, device "
          f"{busy:.3f} ms per solve, idle share {idle:.3f}", flush=True)


def hold_evaluator(label, ev, kernel, src, w, phys, limits, replaced,
                   seed=11):
    """The FFT grid evaluator ``ev`` over the sources src = (sx, sy) against
    the dense CUDA ``kernel`` (sx, sy, *charges, tx, ty) at the physical
    points phys = (flat index, x, y), on charges N(0, 1) times the
    quadrature weights w (two force components where ``limits`` has three
    entries, u v p).  Requires max |evaluator - dense| / max(1, max|dense|)
    <= the limit of each output; prints whether two runs are bit-equal, the
    evaluator's ms per apply and the dense kernel's at ``replaced`` (the
    targets of the dense apply it stands in for).  Returns (evaluator ms,
    dense ms)."""
    rng = np.random.default_rng(seed)
    qs = [torch.as_tensor(rng.standard_normal(w.shape[0]), device=w.device)
          * w for _ in range(2 if len(limits) == 3 else 1)]
    got, again = (ev(*qs) for _ in range(2))
    got, again = (o if isinstance(o, tuple) else (o,) for o in (got, again))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    want = kernel(*src, *qs, phys[1], phys[2])
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    rels = [float((g.reshape(-1)[phys[0]] - d).abs().max())
            / max(1.0, float(d.abs().max())) for g, d in zip(got, want)]
    ev_ms = cuda_ms(lambda: ev(*qs), reps=50)
    dense_ms = cuda_ms(lambda: kernel(*src, *qs, *replaced), reps=50)
    print(f"# {label}: padded box {ev.Px}x{ev.Py}, L {ev.L:.4f}, {ev.S} "
          f"sources, {ev._patches.values().numel()} correction entries; "
          f"max |fft - dense| / max(1, |dense|) at {phys[0].shape[0]} "
          f"physical points {', '.join(f'{r:.3e}' for r in rels)} (limits "
          f"{', '.join(f'{t:.0e}' for t in limits)}); two runs "
          f"{'bit-equal' if bit_equal else 'NOT bit-equal'}; evaluator "
          f"{ev_ms:.4f} ms per apply, the dense kernel it replaces "
          f"({replaced[0].shape[0]} targets) {dense_ms:.4f} ms", flush=True)
    if not all(r <= t for r, t in zip(rels, limits)):
        raise RuntimeError(f"{label}: the FFT evaluator disagrees with the "
                           "dense kernel")
    return ev_ms, dense_ms


def scalar_fft_run(label, make_solver, bie_cls, f, bc, exact, limit,
                   counters, kname, kernel, dense_solver, dense_bie, held):
    """The fft grid backend of a scalar problem on the dense problem's
    collection: build PoissonSolver / ModifiedHelmholtzSolver (``make_solver``)
    and ``bie_cls``, hold both evaluators to the dense kernel, drive the
    solve (launch counts from this run), require its error below ``limit``
    against ``exact``, a GMRES residual <= tol and ``kname`` launches, then
    hold the solve's launches with hold_fft_launches(*held).  Returns that
    run's launches of ``kname`` and the interface launch's max abs
    difference from the plain version."""
    ebdyc = dense_solver.ebdyc
    t0 = time.perf_counter()
    solver = make_solver()
    bie = bie_cls(solver)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.grid_backend != "fft":
        raise RuntimeError(f"{label}: the default grid backend is "
                           f"{solver.grid_backend}, not fft")
    phys = (dense_bie.phys_flat, dense_bie.phys_x, dense_bie.phys_y)
    hold_evaluator(f"{label} [fft] merged sigma_g evaluator",
                   solver.grid_eval, kernel,
                   (solver.grid_src_x, solver.grid_src_y), solver.grid_src_w,
                   phys, (1e-12,),
                   (dense_solver._dense_tx, dense_solver._dense_ty))
    src = bie.src_list[0].dev(ebdyc.device)
    hold_evaluator(f"{label} [fft] BIE evaluator", bie.grid_eval, kernel,
                   (src["x"], src["y"]), src["weights"], phys, (1e-12,),
                   phys[1:])

    def run():
        ue, stats = solver.solve_with_stats(f, tol=GMRES_TOL, maxiter=100,
                                            restart=30)
        ue = bie.apply_bc(ue, bc)
        torch.cuda.synchronize()
        return ue, stats

    (ue, stats), launches, first_s, warm = timed_runs(run, counters)
    grid_err, rad_err = max_err(ebdyc, ue, exact)
    err = max(grid_err, rad_err)
    SHARED[f"{label}_fft_err"] = err
    resid = stats["annular_residuals"][0]
    print(f"# {label} [fft] solve: {stats['annular_iterations'][0]} GMRES "
          f"iterations, residual {resid:.3e}, max error {err:.3e} (grid "
          f"{grid_err:.3e}, radial {rad_err:.3e}; limit {limit:.3g}), "
          f"launches {launches}", flush=True)
    if not (math.isfinite(err) and err < limit):
        raise RuntimeError(f"{label} [fft] error {err:.3e} >= {limit}")
    if not resid <= GMRES_TOL:
        raise RuntimeError(f"{label} [fft] annular GMRES residual "
                           f"{resid:.3e} > {GMRES_TOL}")
    if launches[kname] <= 0:
        raise RuntimeError(f"the {label} fft solve launched no {kname} "
                           "kernel")
    report_backend(label, "fft", setup_s, first_s, warm, run)
    return launches[kname], hold_fft_launches(label, run,
                                              ebdyc.all_interface_x_dev, *held)


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


def hold_fft_launches(label, run, iface_x, module, name, plain, err,
                      bound_of):
    """The launches of ``module.name`` in one fft solve of ``run``: the
    interface launch (targets ``iface_x``: the merged sigma_g onto the
    interface points only, a shape no dense launch has) against the plain
    version, timed, and every launch alone beside its bound
    (time_launches).  Returns the interface launch's max abs difference."""
    kernel = getattr(module, name)
    calls = record_launch_args(run, module, name)
    iface = [a for a in calls if any(t is iface_x for t in a)]
    if len(iface) != 1:
        raise RuntimeError(f"{label} [fft]: {len(iface)} launches onto the "
                           "interface points, not 1")
    abs_err = compare(kernel, plain, err,
                      f"{label} [fft] merged sigma_g -> interface", iface[0],
                      timed=True, plain_reps=2)[0]
    time_launches(f"{name} {label} [fft]", kernel, calls, bound_of)
    return abs_err


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
    ebdyc, grid, f, bc, solver, bie = build_problem(dev, backend="dense")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    SHARED["poisson"] = (ebdyc, f, bc)
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
    print(f"# poisson solve: first {first_s * 1e3:.1f} ms, warm "
          f"{warm_text(warm)}, "
          f"{iters} GMRES iterations, residual {resid:.3e}, "
          f"max error {err:.3e} (grid {grid_err:.3e}, radial {rad_err:.3e}), "
          f"launches {launches}", flush=True)
    if not (math.isfinite(err) and err < TOL_SOLVE_ERR):
        raise RuntimeError(f"poisson solve error {err:.3e} >= {TOL_SOLVE_ERR}")
    if not resid <= GMRES_TOL:
        raise RuntimeError(f"annular GMRES residual {resid:.3e} > {GMRES_TOL}")
    if launches["laplace_slp"] <= 0:
        raise RuntimeError("the Poisson solve launched no laplace_slp kernel")
    report_backend("poisson", "dense", setup_s, first_s, warm, run)
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
    # the fft grid backend (the default) on the same collection
    from ipde_tpu_torch.solvers.bie import DirichletBIE
    from ipde_tpu_torch.solvers.scalar import PoissonSolver
    fft_launches, e = scalar_fft_run(
        "poisson", lambda: PoissonSolver(ebdyc), DirichletBIE, f, bc, sol,
        TOL_SOLVE_ERR, counters, "laplace_slp", K.laplace_slp_apply, solver,
        bie, (K, "laplace_slp_apply", K.laplace_slp_apply_plain, laplace_err,
              lambda sx, sy, w, tx, ty: bound_ms(
                  "laplace_slp", sx.shape[0], tx.shape[0])))
    errs.append(e)
    print(f"# poisson phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    T = merged[3].shape[0]
    bnd, by = bound_ms("laplace_slp", S, T)
    gbnd, gby = bound_ms("laplace_grad", S, T)
    return [{"name": "laplace_slp", "route": "cuda",
             "source": "ipde_tpu_torch/csrc/laplace_slp.cu",
             "replaces": "ipde_tpu/ops/pallas_ds.py:469",
             "launches": launches["laplace_slp"] + fft_launches,
             "max_abs_err": max(errs),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
             "bound_by": by, "library_ms": None},
            {"name": "laplace_grad", "route": "cuda",
             "source": "ipde_tpu_torch/csrc/laplace_grad.cu",
             "replaces": "ipde_tpu/ops/pallas_ds.py:479",
             "launches": launches["laplace_grad"],
             "max_abs_err": max(grad_errs), "ms": gms,
             "plain_ms": gplain_ms, "bound_ms": gbnd, "bound_by": gby,
             "library_ms": None}]


def stokes_fft_run(SK, counters, dense_solver, dense_bie, fs, bcs):
    """The fft grid backend of the Stokes problem on the dense problem's
    collection, as scalar_fft_run: both Stokeslet evaluators held to the
    dense kernel (u, v to 1e-10, p to 1e-11 of max(1, max|dense|)), the
    solve's velocity and pressure errors, residual and stokes_slp launches,
    and the solve's launches held with hold_fft_launches.  Returns that
    run's launches and the interface launch's max abs difference from the
    plain version."""
    from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
    from ipde_tpu_torch.solvers.vector import StokesSolver
    ebdyc = dense_solver.ebdyc
    t0 = time.perf_counter()
    solver = StokesSolver(ebdyc)
    bie = StokesDirichletBIE(solver)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.grid_backend != "fft":
        raise RuntimeError(f"stokes: the default grid backend is "
                           f"{solver.grid_backend}, not fft")
    phys = (dense_bie.phys_flat, dense_bie.phys_x, dense_bie.phys_y)
    limits = (1e-10, 1e-10, 1e-11)
    hold_evaluator("stokes [fft] merged sigma_g evaluator", solver.grid_eval,
                   SK.stokes_slp_apply, (solver.grid_src_x, solver.grid_src_y),
                   solver.grid_src_w, phys, limits,
                   (dense_solver._dense_tx, dense_solver._dense_ty))
    src = bie.src_list[0].dev(ebdyc.device)
    hold_evaluator("stokes [fft] BIE evaluator", bie.grid_eval,
                   SK.stokes_slp_apply, (src["x"], src["y"]), src["weights"],
                   phys, limits, phys[1:])

    def run():
        (u, v, p), stats = solver.solve_with_stats(
            *fs, tol=GMRES_TOL, maxiter=100, restart=30)
        u, v, p = bie.apply_bc(u, v, p, *bcs)
        torch.cuda.synchronize()
        return (u, v, p), stats

    ((u, v, p), stats), launches, first_s, warm = timed_runs(run, counters)
    g = ebdyc.grid
    vel_err = max(max(max_err(ebdyc, u, usol)), max(max_err(ebdyc, v, vsol)))
    shift = float((p.grid.cpu().numpy() - psol(g.xg, g.yg))[ebdyc.phys]
                  .mean())
    p_err = max(max_err(ebdyc, p, psol, shift))
    resid = stats["annular_residuals"][0]
    print(f"# stokes [fft] solve: {stats['annular_iterations'][0]} GMRES "
          f"iterations, residual {resid:.3e}, velocity error {vel_err:.4e}, "
          f"pressure error {p_err:.3e} (mean shift {shift:.3e}), launches "
          f"{launches}", flush=True)
    if not (math.isfinite(vel_err) and vel_err < TOL_STOKES_VEL):
        raise RuntimeError(f"stokes [fft] velocity error {vel_err:.4e} >= "
                           f"{TOL_STOKES_VEL}")
    if not (math.isfinite(p_err) and p_err < TOL_STOKES_P):
        raise RuntimeError(f"stokes [fft] pressure error {p_err:.3e} >= "
                           f"{TOL_STOKES_P}")
    if not resid <= GMRES_TOL:
        raise RuntimeError(f"stokes [fft] annular GMRES residual "
                           f"{resid:.3e} > {GMRES_TOL}")
    if launches["stokes_slp"] <= 0:
        raise RuntimeError("the Stokes fft solve launched no stokes_slp "
                           "kernel")
    report_backend("stokes", "fft", setup_s, first_s, warm, run)
    return launches["stokes_slp"], hold_fft_launches(
        "stokes", run, ebdyc.all_interface_x_dev, SK, "stokes_slp_apply",
        SK.stokes_slp_apply_plain, stokes_err,
        lambda sx, sy, wfx, wfy, tx, ty: bound_ms("stokes_slp", sx.shape[0],
                                                  tx.shape[0]))


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
    ebdyc, grid, (fu, fv), (bcu, bcv), solver, bie = build_stokes_problem(
        backend="dense")
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
    src = bie.src_list[0].dev(dev)
    n = src["x"].shape[0]
    errs.append(compare(*sto, "BIE source -> physical grid",
                        (src["x"], src["y"], q[0][:n].contiguous(),
                         q[1][:n].contiguous(), bie.phys_x, bie.phys_y))[0])
    f0, tx, ty, gsx, gsy, gw = bie.radial_plans[0][0].groups[0]
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
    print(f"# stokes solve: first {first_s * 1e3:.1f} ms, warm "
          f"{warm_text(warm)}, "
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
    report_backend("stokes", "dense", setup_s, first_s, warm, run)
    time_launches("stokes_slp", SK.stokes_slp_apply,
                  record_launch_args(run, SK, "stokes_slp_apply"),
                  lambda sx, sy, wfx, wfy, tx, ty: bound_ms(
                      "stokes_slp", sx.shape[0], tx.shape[0]))
    print("# stokes annular GMRES alone (maxiter 100, restart 30): "
          + "; ".join(f"tol {t:.0e}: {i} iterations, true residual {r:.3e}"
                      for t, i, r in gmres_floor(solver, fu, fv)), flush=True)
    fft_launches, e = stokes_fft_run(SK, counters, solver, bie, (fu, fv),
                                     (bcu, bcv))
    errs.append(e)
    print(f"# stokes phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    bnd, by = bound_ms("stokes_slp", S, T_merged)
    return {"name": "stokes_slp", "route": "cuda",
            "source": "ipde_tpu_torch/csrc/stokes_slp.cu",
            "replaces": "ipde_tpu/ops/pallas_ds.py:510",
            "launches": launches["stokes_slp"] + fft_launches,
            "max_abs_err": max(errs),
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
        ebdyc, grid, f, bc, solver, bie = build_mh_problem(
            dev, k, nb, M, bie_kind, backend="dense")
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
        print(f"# {name} solve: first {first_s * 1e3:.1f} ms, warm "
              f"{warm_text(warm)}, "
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
        report_backend(name, "dense", setup_s, first_s, warm, run)
        time_launches(f"mh_slp {name}", K.mh_slp_apply,
                      record_launch_args(run, K, "mh_slp_apply"),
                      lambda sx, sy, w, tx, ty, k: mh_bound_ms(sx, sy, tx, ty,
                                                               k))
        total_launches += launches["mh_slp"]
        if bie_kind == "dirichlet":
            # the fft grid backend (the default) on the same collection; the
            # k = 100 Neumann problem stays dense-only here (its host setup
            # alone is over a minute; tests/test_torch_grid_eval_slices.py
            # holds the fft branch of NeumannBIE on the CPU)
            from ipde_tpu_torch.solvers.bie import DirichletBIE
            from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver
            n, e = scalar_fft_run(
                name, lambda: ModifiedHelmholtzSolver(ebdyc, k=k),
                DirichletBIE, f, bc, mh_sol, limit, counters, "mh_slp",
                lambda sx, sy, q, tx, ty: K.mh_slp_apply(sx, sy, q, tx, ty,
                                                         k),
                solver, bie, (K, "mh_slp_apply", K.mh_slp_apply_plain,
                              laplace_err,
                              lambda sx, sy, w, tx, ty, k: mh_bound_ms(
                                  sx, sy, tx, ty, k)))
            total_launches += n
            errs.append(e)
        if entry is None:      # the kernels line times the k = 2 merged apply
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by}
    print(f"# mh phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {"name": "mh_slp", "route": "cuda",
            "source": "ipde_tpu_torch/csrc/mh_slp.cu",
            "replaces": "ipde_tpu/ops/pallas_ds.py:495",
            "launches": total_launches, "max_abs_err": max(errs), **entry,
            "library_ms": None}


# ---------------------------------------------------------------------------
# the multi-body phase: several boundaries and inclusions
# ---------------------------------------------------------------------------

def max_err_all(ebdyc, ef, f, shift=0.0):
    """max |ef - f - shift| over the physical grid points and every
    boundary's radial nodes: (grid, [per boundary])."""
    g = ebdyc.grid
    grid_err = np.abs(ef.grid.cpu().numpy() - f(g.xg, g.yg)
                      - shift)[ebdyc.phys].max()
    return float(grid_err), [
        float(np.abs(r.cpu().numpy() - f(e.radial_x, e.radial_y)
                     - shift).max()) for r, e in zip(ef.radials, ebdyc)]


def build_three_body_stokes(dev, nb=STOKES3_NB, M=STOKES3_M):
    """examples/stokes_refinement.py::run_case(nb, M)'s collection: the
    outer star(nb, a=0.1, f=3) with M, two star inclusions of nb / 2 points
    with M_i = max(M // 2 + 2, 6), h = min(min_h, 0.6 / max|kappa| / M,
    0.16 / M); its manufactured solution (bench.py's)."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary

    outer = star(nb, a=0.1, f=3)
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M,
             0.16 / M)
    Mi = max(M // 2 + 2, 6)
    ebdyc = EmbeddedBoundaryCollection([
        EmbeddedBoundary(outer, True, M, bh),
        EmbeddedBoundary(star(nb // 2, x=0.3, y=0.18, r=0.16, a=0.05, f=4),
                         False, Mi, bh),
        EmbeddedBoundary(star(nb // 2, x=-0.28, y=-0.22, r=0.15, a=0.05,
                              f=3), False, Mi, bh)], device=dev)
    grid = ebdyc.generate_grid(bh)
    data = ((EmbeddedFunction.from_function(ebdyc, fuf),
             EmbeddedFunction.from_function(ebdyc, fvf)),
            (BoundaryFunction.from_function(ebdyc, usol),
             BoundaryFunction.from_function(ebdyc, vsol)))
    return ebdyc, grid, data


def build_three_body_mh(dev, nb=200, M=10):
    """tests/test_multi_body.py's collection (one interior star of 3 nb / 2
    points, a star and a squished-circle inclusion of nb points, all M) and
    its Yukawa (k = 2) data."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import squished_circle, star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary

    b1 = star(3 * nb // 2, a=0.1, f=5, r=2.0)
    b2 = star(nb, x=-0.8, y=-0.5, a=0.1, f=3, r=0.45)
    b3 = squished_circle(nb, x=0.7, y=0.6, r=0.5, b=0.7, rot=np.pi / 5)
    kmax = max(np.abs(b.curvature).max() for b in (b1, b2, b3))
    bh = min(min(b.min_h() for b in (b1, b2, b3)), 0.6 / kmax / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(b, b is b1, M, bh, qfs_tolerance=1e-14)
         for b in (b1, b2, b3)], device=dev)
    grid = ebdyc.generate_grid(bh)
    k = MH3_K
    data = (EmbeddedFunction.from_function(
        ebdyc, lambda x, y: k * k * mh_sol(x, y) - mh_lap_sol(x, y)),
        BoundaryFunction.from_function(ebdyc, mh_sol))
    return ebdyc, grid, data


def build_inclusion_poisson(dev, M=10):
    """tests/test_exterior.py::test_exterior_boundary_poisson_solve's
    collection (star(300, a=0.1, f=3) and the inclusion star(200, x=0.15,
    y=-0.1, r=0.35, a=0.08, f=4), both M) and its Poisson data."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary

    outer = star(300, a=0.1, f=3)
    bh = min(outer.min_h(), 0.6 / np.abs(outer.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection([
        EmbeddedBoundary(outer, True, M, bh),
        EmbeddedBoundary(star(200, x=0.15, y=-0.1, r=0.35, a=0.08, f=4),
                         False, M, bh)], device=dev)
    grid = ebdyc.generate_grid(bh)
    data = (EmbeddedFunction.from_function(ebdyc, frc),
            BoundaryFunction.from_function(ebdyc, sol))
    return ebdyc, grid, data


def multi_problems():
    """(label, builder, kernel name, solver factory (ebdyc, backend),
    BIE class, run(solver, bie, data) -> (fields, stats), check(ebdyc,
    fields) -> (error, limit, text)) of the three multi-body problems."""
    from ipde_tpu_torch.solvers.bie import DirichletBIE, StokesDirichletBIE
    from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                               PoissonSolver)
    from ipde_tpu_torch.solvers.vector import StokesSolver

    def stokes_run(solver, bie, data):
        (fu, fv), bcs = data
        (u, v, p), stats = solver.solve_with_stats(
            fu, fv, tol=GMRES_TOL, maxiter=100, restart=30)
        return bie.apply_bc(u, v, p, *bcs), stats

    def scalar_run(solver, bie, data):
        f, bc = data
        ue, stats = solver.solve_with_stats(f, tol=GMRES_TOL, maxiter=100,
                                            restart=30)
        return bie.apply_bc(ue, bc), stats

    def stokes_check(ebdyc, out):
        u, v, p = out
        (ug, ur), (vg, vr) = (max_err_all(ebdyc, u, usol),
                              max_err_all(ebdyc, v, vsol))
        err = max(ug, vg, *ur, *vr)
        g = ebdyc.grid
        shift = float((p.grid.cpu().numpy() - psol(g.xg, g.yg))
                      [ebdyc.phys].mean())
        pg, pr = max_err_all(ebdyc, p, psol, shift)
        return err, TOL_STOKES3_VEL, (
            f"velocity error {err:.4e} (grid {max(ug, vg):.3e}, radial "
            f"{', '.join(f'{max(a, b):.3e}' for a, b in zip(ur, vr))}); "
            f"limit {TOL_STOKES3_VEL:.4e} = 3 x ipde_tpu's CPU error on this "
            f"case with the port's BIE radial plans "
            f"({IPDE_TPU_STOKES3_CPU['port']:.4e}); ipde_tpu as shipped "
            f"{IPDE_TPU_STOKES3_CPU['ipde_tpu']:.4e}; the example's rule "
            f"against the reference paper's row, {TOL_STOKES3_PAPER:.4e}, "
            f"{'met' if err <= TOL_STOKES3_PAPER else 'NOT met'}; pressure "
            f"error {max(pg, *pr):.3e} after a mean shift of {shift:.3e}")

    def scalar_check(exact, limit):
        def check(ebdyc, ue):
            g, r = max_err_all(ebdyc, ue, exact)
            err = max(g, *r)
            return err, limit, (
                f"max error {err:.3e} (grid {g:.3e}, radial "
                f"{', '.join(f'{a:.3e}' for a in r)}; limit {limit:.3g})")
        return check

    return (
        ("stokes_3body", build_three_body_stokes, "stokes_slp",
         lambda c, b: StokesSolver(c, grid_backend=b), StokesDirichletBIE,
         stokes_run, stokes_check),
        ("mh_3body_k2", build_three_body_mh, "mh_slp",
         lambda c, b: ModifiedHelmholtzSolver(c, k=MH3_K, grid_backend=b),
         DirichletBIE, scalar_run, scalar_check(mh_sol, TOL_MH3)),
        ("poisson_inclusion", build_inclusion_poisson, "laplace_slp",
         lambda c, b: PoissonSolver(c, grid_backend=b), DirichletBIE,
         scalar_run, scalar_check(sol, TOL_INCLUSION)))


def kernel_holds(K, SK):
    """(module, wrapper name, plain version, error measure, bound) of each
    kernel the solvers launch, as hold_distinct_launches takes them."""
    return {"stokes_slp": (SK, "stokes_slp_apply", SK.stokes_slp_apply_plain,
                           stokes_err,
                           lambda sx, sy, wfx, wfy, tx, ty: bound_ms(
                               "stokes_slp", sx.shape[0], tx.shape[0])),
            "mh_slp": (K, "mh_slp_apply", K.mh_slp_apply_plain, laplace_err,
                       lambda sx, sy, w, tx, ty, k: mh_bound_ms(
                           sx, sy, tx, ty, k)),
            "laplace_slp": (K, "laplace_slp_apply", K.laplace_slp_apply_plain,
                            laplace_err,
                            lambda sx, sy, w, tx, ty: bound_ms(
                                "laplace_slp", sx.shape[0], tx.shape[0]))}


def record_all_launch_args(fn, holds):
    """``fn()`` run once with each kernel of ``holds`` (kernel_holds)
    wrapped by record_launch_args; returns (its result, the recorded calls
    by kernel name)."""
    names, out, calls = list(holds), [], {}

    def run(i=0):
        if i == len(names):
            out.append(fn())
        else:
            module, attr = holds[names[i]][:2]
            calls[names[i]] = record_launch_args(lambda: run(i + 1), module,
                                                 attr)

    run()
    return out[0], calls


def hold_distinct_launches(label, run, module, name, plain, err, bound_of):
    """Every launch of ``module.name`` in one run of ``run`` (one solve +
    apply_bc), held by hold_calls.  Returns the largest max abs difference
    from the plain version."""
    return hold_calls(label, record_launch_args(run, module, name),
                      getattr(module, name), plain, err, bound_of,
                      "one solve + apply_bc")


def hold_calls(label, calls, kernel, plain, err, bound_of, where):
    """Recorded launches ``calls`` of ``kernel``: the count, each distinct
    (T, S) against the plain version (TOL_KERNEL_REL) and alone beside its
    bound, two runs bit for bit (time_launches).  Returns the largest max
    abs difference from the plain version."""
    shapes = {}
    for a in calls:
        T = next(t for t in reversed(a) if isinstance(t, torch.Tensor))
        shapes.setdefault((T.shape[0], a[0].shape[0]), a)
    print(f"# {label}: {len(calls)} {kernel.__name__} launches in {where}, "
          f"{len(shapes)} distinct (T, S): "
          f"{sorted(shapes)}", flush=True)
    errs = [compare(kernel, plain, err, f"{label} T={T} S={S}", a,
                    plain_reps=1)[0] for (T, S), a in sorted(shapes.items())]
    time_launches(f"{kernel.__name__} {label}", kernel,
                  [shapes[k] for k in sorted(shapes)], bound_of,
                  what=f"distinct launch shapes of {where}")
    return max(errs)


def hold_batched(label, helpers, rhss, batched, one):
    """The lockstep GMRES of ``batched`` over ``helpers`` (one (M, n)) on
    ``rhss`` against one solve per helper (``one(h, i)`` -> (solution
    tuple, stats)): solutions within 1e-10 of max |loop| (a pressure, the
    third of three, after its mean), iterations within one, residuals <=
    tol; times both."""
    solvers = [h.annular_solver for h in helpers]
    metrics = [h.metric for h in helpers]

    def run_batched():
        out = batched(solvers, metrics, rhss, GMRES_TOL, 100, 30)
        torch.cuda.synchronize()
        return out

    def run_loop():
        out = [one(h, i) for i, h in enumerate(helpers)]
        torch.cuda.synchronize()
        return out

    got, st = run_batched()
    loop = run_loop()
    gap = 0.0
    for g, (w, _) in zip(got, loop):
        g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
        for k, (a, b) in enumerate(zip(g, w)):
            c = (a.mean() - b.mean()) if k == 2 else 0.0
            gap = max(gap, float((a - b - c).abs().max() / b.abs().max()))
    its = [s["iterations"] for _, s in loop]
    b_ms = 1e3 * statistics.median(timed(run_batched) for _ in range(5))
    l_ms = 1e3 * statistics.median(timed(run_loop) for _ in range(5))
    print(f"# {label}: batched GMRES over {len(helpers)} annuli of (M, n) = "
          f"{(solvers[0].M, solvers[0].n)}: iterations {st['iterations']} "
          f"(loop {its}), residuals "
          f"{', '.join(f'{r:.3e}' for r in st['residual'])}, max |batched - "
          f"loop| / max |loop| {gap:.3e} (limit 1e-10); median of 5: "
          f"batched {b_ms:.2f} ms, loop {l_ms:.2f} ms", flush=True)
    if not (gap <= 1e-10 and max(st["residual"]) <= GMRES_TOL
            and all(abs(a - b) <= 1 for a, b in zip(st["iterations"], its))):
        raise RuntimeError(f"{label}: the batched GMRES disagrees with the "
                           "per-boundary loop")


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def multi_body_phase(dev, K, SK, counters):
    """The multi-body phase (see the module docstring); returns the main-path
    launches of each kernel and the largest max abs difference from the
    plain version of each kernel held here."""
    from ipde_tpu_torch.solvers.annular_scalar import batched_annular_solve
    from ipde_tpu_torch.solvers.annular_stokes import batched_stokes_solve
    t_phase = time.perf_counter()
    holds = kernel_holds(K, SK)
    launches = {name: 0 for name in counters}
    errs = {name: 0.0 for name in counters}
    kept = {}
    for (label, build, kname, make_solver, bie_cls, run_fn,
         check) in multi_problems():
        t0 = time.perf_counter()
        ebdyc, grid, data = build(dev)
        geo_s = time.perf_counter() - t0
        SHARED[label] = (ebdyc, data)
        dof = int(ebdyc.phys.sum() + sum(np.prod(e.radial_shape)
                                         for e in ebdyc))
        print(f"# {label} collection {geo_s:.2f} s: grid {grid.shape}, {dof} "
              f"dof, boundaries (N, M, interior) "
              f"{[(e.bdy.N, e.M, e.interior) for e in ebdyc]}", flush=True)
        for backend in ("dense", "fft"):
            t0 = time.perf_counter()
            solver = make_solver(ebdyc, backend)
            bie = bie_cls(solver)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0

            def run():
                out = run_fn(solver, bie, data)
                torch.cuda.synchronize()
                return out

            (out, stats), got, first_s, warm = timed_runs(run, counters)
            err, limit, text = check(ebdyc, out)
            resid = max(stats["annular_residuals"])
            print(f"# {label} [{backend}] solve: GMRES iterations "
                  f"{stats['annular_iterations']}, max residual "
                  f"{resid:.3e}, {text}, launches {got}", flush=True)
            if not (math.isfinite(err) and err <= limit):
                raise RuntimeError(f"{label} [{backend}] error {err:.4e} > "
                                   f"{limit:.4e}")
            if not resid <= GMRES_TOL:
                raise RuntimeError(f"{label} [{backend}] annular GMRES "
                                   f"residual {resid:.3e} > {GMRES_TOL}")
            if got[kname] <= 0:
                raise RuntimeError(f"the {label} [{backend}] solve launched "
                                   f"no {kname} kernel")
            for name, n in got.items():
                launches[name] += n
            report_backend(label, backend, setup_s, first_s, warm, run)
            if backend == "fft":
                errs[kname] = max(errs[kname], hold_distinct_launches(
                    f"{label} [fft]", run, *holds[kname]))
        kept[label] = (solver, data)
    # the lockstep GMRES on the card: the two same-shape inclusions of the
    # three-body Stokes and Yukawa problems against their per-boundary loop
    solver, ((fu, fv), _) = kept["stokes_3body"]
    hs = solver.helpers[1:]
    hold_batched(
        "stokes_3body inclusions", hs,
        [h.annular_rhs(a, b) for h, a, b in zip(hs, fu.radials[1:],
                                                fv.radials[1:])],
        batched_stokes_solve,
        lambda h, i: h.annular_solver.solve_with_stats(
            h.metric, *h.uv_to_rt(fu.radials[1 + i], fv.radials[1 + i]),
            h.zero_bc, h.zero_bc, h.zero_bc, h.zero_bc, tol=GMRES_TOL,
            maxiter=100, restart=30))
    solver, (f, _) = kept["mh_3body_k2"]
    hs = solver.helpers[1:]
    hold_batched(
        "mh_3body_k2 inclusions", hs,
        [h.annular_rhs(r) for h, r in zip(hs, f.radials[1:])],
        batched_annular_solve,
        lambda h, i: h.annular_solver.solve_with_stats(
            h.metric, f.radials[1 + i], h.zero_bc, h.zero_bc, tol=GMRES_TOL,
            maxiter=100, restart=30))
    print(f"# multi-body phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return launches, errs


# ---------------------------------------------------------------------------
# the moving-boundary path (stepper, advectors) and the tier-2 interface plan
# ---------------------------------------------------------------------------

def coupled_exact(x, y, T):
    """The diffusing Gaussian of examples/coupled_advection_diffusion.py."""
    s = 4 * ADV_NU * (T + ADV_T0)
    return np.exp(-(x * x + y * y) / s) / (np.pi * s)


def rel_err_all(ebdyc, ef, exact):
    """max |ef - exact| over the physical grid points and every radial grid,
    over max |exact| on the physical grid points (the examples' rule)."""
    g = ebdyc.grid
    want = exact(g.xg, g.yg)
    ge = np.abs(ef.grid.cpu().numpy() - want)[ebdyc.phys].max()
    re = max(np.abs(fr.cpu().numpy() - exact(e.radial_x, e.radial_y)).max()
             for e, fr in zip(ebdyc, ef.radials))
    return float(max(ge, re) / np.abs(want[ebdyc.phys]).max())


def stepper_phase(dev, K, counters):
    """examples/coupled_advection_diffusion.py at its defaults through
    CoupledAdvectionDiffusionStepper: every count set to 0 before step 1 and
    read after step 4; step 2 traced by torch.profiler (device ms, idle
    share), the mh_slp launches of step 3 recorded and, after the run, each
    distinct (T, S) held to the plain version, timed beside its bound, two
    runs bit for bit; the relative error against the exact solution within
    TOL_COUPLED_ABS of ipde_tpu's.  Returns (mh_slp launches, max abs
    difference from the plain version)."""
    from ipde_tpu_torch.advection.stepper import \
        CoupledAdvectionDiffusionStepper
    from ipde_tpu_torch.functions import EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    t_phase = time.perf_counter()
    bdy = star(ADV_NB, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / ADV_M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, ADV_M, bh, qfs_tolerance=1e-12)],
        device=dev)
    grid = ebdyc.generate_grid(bh, pad_quantum=ADV_PQ)
    c = EmbeddedFunction.from_function(
        ebdyc, lambda x, y: coupled_exact(x, y, 0.0))

    def velocity(ec):
        return (EmbeddedFunction.from_function(ec, lambda x, y: -y),
                EmbeddedFunction.from_function(ec, lambda x, y: x))

    stepper = CoupledAdvectionDiffusionStepper(ebdyc, velocity, ADV_NU,
                                               ADV_DT, tol=GMRES_TOL)
    print(f"# stepper: star({ADV_NB}, a=0.1, f=3), M={ADV_M}, grid "
          f"{grid.shape}, pad_quantum {ADV_PQ} (pna {ebdyc.pna_x.size} of "
          f"{ebdyc.phys_not_in_annulus.sum()} real), k = {stepper.k:g}, "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    state = {"c": c}

    def step():
        state["c"] = stepper.step(state["c"])

    for cnt in counters.values():
        cnt.launches = 0
    calls, per_step = [], []
    for n in range(ADV_STEPS):
        before = K.mh_slp_apply.launches
        t0 = time.perf_counter()
        if n == 1:
            wall, busy, idle = profile_device(step, reps=1)
            prof = (f"; profiled (profiler on): wall {wall:.3f} ms, device "
                    f"{busy:.3f} ms, idle share {idle:.3f}")
        elif n == 2:
            calls = record_launch_args(step, K, "mh_slp_apply")
            prof = ""
        else:
            step()
            prof = ""
        wall_s = time.perf_counter() - t0
        per_step.append(K.mh_slp_apply.launches - before)
        t = stepper.last_times
        print(f"# stepper step {n + 1}/{ADV_STEPS}: generate "
              f"{t['generate_s']:.3f} s, advect {t['advect_s']:.3f} s, setup "
              f"{t['setup_s']:.3f} s, solve {t['solve_s']:.3f} s (step "
              f"{wall_s:.3f} s), mh_slp launches {per_step[-1]}{prof}",
              flush=True)
    launches = {name: cnt.launches for name, cnt in counters.items()}
    T_end = ADV_STEPS * ADV_DT
    err = rel_err_all(stepper.ebdyc, state["c"],
                      lambda x, y: coupled_exact(x, y, T_end))
    mass = stepper.ebdyc.volume_integral(state["c"])
    ref = IPDE_TPU_COUPLED_CPU
    print(f"# stepper: rel err {err:.10e} after T={T_end:g} (ipde_tpu on the "
          f"CPU {ref['rel_err']:.10e}, |diff| {abs(err - ref['rel_err']):.3e}"
          f", limit {TOL_COUPLED_ABS:.0e}), final mass {mass:.15f} "
          f"(ipde_tpu {ref['mass']:.15f}), recompiles {stepper.recompiles}, "
          f"launches {launches}", flush=True)
    if not (math.isfinite(err) and abs(err - ref["rel_err"])
            <= TOL_COUPLED_ABS):
        raise RuntimeError(f"stepper error {err:.10e} differs from ipde_tpu's "
                           f"{ref['rel_err']:.10e} by more than "
                           f"{TOL_COUPLED_ABS}")
    if min(per_step) <= 0:
        raise RuntimeError(f"a stepper step launched no mh_slp kernel: "
                           f"{per_step}")
    mh_err = hold_calls(
        "stepper step 3", calls, K.mh_slp_apply, K.mh_slp_apply_plain,
        laplace_err, lambda sx, sy, w, tx, ty, k: mh_bound_ms(
            sx, sy, tx, ty, k), "one stepper step")
    print(f"# stepper phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches["mh_slp"], mh_err


def unsteady_case(scheme, dt, steps, ebdyc):
    """examples/unsteady_advection_study.py::run_case on the port: the
    rotation of rate w(t) = 1 + 0.5 sin(2t) on the fixed boundary, history
    from the exact solution; returns (error, seconds per step)."""
    from ipde_tpu_torch.advection.semi_lagrangian import (
        SecondOrderAdvector, SemiLagrangianAdvector, ThirdOrderAdvector)
    from ipde_tpu_torch.functions import EmbeddedFunction

    def exact(x, y, t):
        a = t + 0.25 * (1.0 - np.cos(2.0 * t))
        c, s = np.cos(a), np.sin(a)
        X, Y = c * x + s * y, -s * x + c * y
        return np.exp(np.sin(X)) * np.cos(Y + 0.3)

    def vel(t):
        w = 1.0 + 0.5 * np.sin(2.0 * t)
        return (EmbeddedFunction.from_function(ebdyc, lambda x, y: -w * y),
                EmbeddedFunction.from_function(ebdyc, lambda x, y: w * x))

    def ex(t):
        return EmbeddedFunction.from_function(
            ebdyc, lambda x, y: exact(x, y, t))

    class Hist:
        def __init__(self, u, v, uo, vo):
            self.u, self.v, self.uo, self.vo = u, v, uo, vo

    f, fm1, fm2 = ex(0.0), ex(-dt), ex(-2 * dt)
    t = 0.0
    prev = None
    t0 = time.perf_counter()
    for _ in range(steps):
        u, v = vel(t)
        if scheme == "fe":
            adv = SemiLagrangianAdvector(ebdyc, u, v)
            adv.generate(dt, fixed_boundary=True)
            fn = adv(f)
        elif scheme == "bdf2":
            if prev is None:
                prev = SemiLagrangianAdvector(ebdyc, *vel(t - dt))
                prev.generate(dt, fixed_boundary=True)
            adv = SecondOrderAdvector(ebdyc, u, v, prev)
            adv.generate(dt, fixed_boundary=True)
            fn = adv.advect_bdf2(f, fm1)
        else:
            adv = ThirdOrderAdvector(ebdyc, u, v,
                                     Hist(*vel(t - dt), *vel(t - 2 * dt)))
            adv.generate(dt)
            fn = adv(f, fm1, fm2)
        prev = adv
        fm2, fm1, f = fm1, f, fn
        t += dt
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    fa = ex(t)
    ge = float((f.grid - fa.grid).abs()[ebdyc.phys_dev].max())
    re = max(float((a - b).abs().max()) for a, b in zip(f.radials,
                                                        fa.radials))
    return max(ge, re), step_s


def advector_phase(dev):
    """FE, BDF2 and BDF3 of examples/unsteady_advection_study.py at
    dt = UNSTEADY_DT to UNSTEADY_T, each error within TOL_UNSTEADY_REL of
    ipde_tpu's on the CPU."""
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import circle
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    t_phase = time.perf_counter()
    bdy = circle(UNSTEADY_NB, r=1.0)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / UNSTEADY_M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, UNSTEADY_M, bh, qfs_tolerance=1e-12)],
        device=dev)
    ebdyc.generate_grid(bh)
    steps = int(round(UNSTEADY_T / UNSTEADY_DT))
    for scheme, ref in IPDE_TPU_UNSTEADY_CPU.items():
        err, step_s = unsteady_case(scheme, UNSTEADY_DT, steps, ebdyc)
        gap = abs(err - ref) / ref
        print(f"# advector {scheme}: circle({UNSTEADY_NB}), M={UNSTEADY_M}, "
              f"grid {ebdyc.grid.shape}, dt {UNSTEADY_DT}, {steps} steps: "
              f"error {err:.10e} (ipde_tpu on the CPU {ref:.10e}, relative "
              f"difference {gap:.3e}, limit {TOL_UNSTEADY_REL}), "
              f"{step_s:.3f} s per step", flush=True)
        if not (math.isfinite(err) and gap <= TOL_UNSTEADY_REL):
            raise RuntimeError(f"advector {scheme} error {err:.4e} is not "
                               f"within {TOL_UNSTEADY_REL} of {ref:.4e}")
    print(f"# advector phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)


def tier2_interface_phase(dev):
    """Bench tier 2's geometry and box: generate_grid (which builds the
    interface plan through make_interpolator) must give a
    PeriodicInterpolator2D; its values and from_modes_grad for one smooth
    box-periodic field are held to ExactInterp2D on the same targets,
    relative to the field's max, and both are timed."""
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.ops.interp import ExactInterp2D, PeriodicInterpolator2D
    t_phase = time.perf_counter()
    bdy = star(TIER2_NB, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / TIER2_M)
    extent = float(bdy.x.max() - bdy.x.min())
    bh = min(bh, extent / (TIER2_GRID_TARGET - 3 * TIER2_M))
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, TIER2_M, bh, qfs_tolerance=1e-14)],
        device=dev)
    t0 = time.perf_counter()
    grid = ebdyc.generate_grid(bh)
    torch.cuda.synchronize()
    geo_s = time.perf_counter() - t0
    plan = ebdyc.interface_interp
    print(f"# tier-2 interface: star({TIER2_NB}, a=0.2, f=5), M={TIER2_M}, "
          f"grid {grid.shape}, {plan.T} interface targets -> "
          f"{type(plan).__name__} (sigma fine grid {plan.plan.nfx}x"
          f"{plan.plan.nfy}, w {plan.w}); generate_grid {geo_s:.2f} s",
          flush=True)
    if not isinstance(plan, PeriodicInterpolator2D):
        raise RuntimeError(f"the tier-2 interface plan is "
                           f"{type(plan).__name__}, not PeriodicInterpolator2D")
    tx, ty = ebdyc.transf(ebdyc.all_interface_x, ebdyc.all_interface_y)
    t0 = time.perf_counter()
    exact = ExactInterp2D(grid.Nx, grid.Ny, tx, ty, device=dev)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    X = (grid.xg - grid.x_bounds[0]) / grid.x_period * 2 * np.pi
    Y = (grid.yg - grid.y_bounds[0]) / grid.y_period * 2 * np.pi
    f = torch.as_tensor(np.exp(np.sin(X)) * np.cos(2 * Y + 0.3), device=dev)
    modes = torch.fft.fft2(f)
    got = plan.from_modes_grad(modes)
    want = exact.from_modes_grad(modes)
    scale = float(f.abs().max())
    gaps = [float((a - b).abs().max()) / scale for a, b in zip(got, want)]
    vals_gap = float((plan.from_modes(modes) - want[0]).abs().max()) / scale
    ms = cuda_ms(lambda: plan.from_modes_grad(modes))
    exact_ms = cuda_ms(lambda: exact.from_modes_grad(modes))
    print(f"# tier-2 interface: PeriodicInterpolator2D vs ExactInterp2D "
          f"(relative to max|f| {scale:.4f}): values {vals_gap:.3e}, "
          f"from_modes_grad value / d/dtx / d/dty "
          f"{' / '.join(f'{g:.3e}' for g in gaps)} (limit "
          f"{TOL_INTERFACE_REL:.0e}); from_modes_grad {ms:.4f} ms, exact "
          f"{exact_ms:.4f} ms (its phase matrices built in {exact_s:.2f} s); "
          f"phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    if not max(gaps + [vals_gap]) <= TOL_INTERFACE_REL:
        raise RuntimeError("the tier-2 interface plan disagrees with "
                           "ExactInterp2D")


# ---------------------------------------------------------------------------
# phase 7: solver_type="fourth", the periodic evaluator, the example scripts
# ---------------------------------------------------------------------------

def fourth_run(label, setup_s, run, check, counters, kname, held, beside):
    """One fourth-order solve + apply_bc on a collection of an earlier
    phase: ``run()`` driven with every count set to 0 just before and read
    just after; its error from ``check`` must be within 1% of ipde_tpu's
    CPU error (either side) and below the reference test's assert, its
    residual <= tol, with
    ``kname`` launches; the timing lines of the other phases; every distinct
    launch held by hold_distinct_launches(*held).  Returns (launches by
    kernel, max abs difference from the plain version)."""
    (out, stats), launches, first_s, warm = timed_runs(run, counters)
    err, text = check(out)
    ref = IPDE_TPU_FOURTH_CPU[label]
    gap = abs(err / ref - 1.0)
    resid = max(stats["annular_residuals"])
    print(f"# fourth {label} solve: GMRES iterations "
          f"{stats['annular_iterations']}, max residual {resid:.3e}, {text} "
          f"(ipde_tpu on the CPU {ref:.10e}, ratio {err / ref:.7f}, "
          f"|err - ipde_tpu| {abs(err - ref):.3e}; limits |ratio - 1| <= "
          f"{TOL_FOURTH_REL} and err < {TOL_FOURTH[label]:g}); {beside}; "
          f"launches {launches}", flush=True)
    if not (math.isfinite(err) and gap <= TOL_FOURTH_REL
            and err < TOL_FOURTH[label]):
        raise RuntimeError(f"fourth {label} error {err:.6e} is not within "
                           f"{TOL_FOURTH_REL} of ipde_tpu's {ref:.6e} or "
                           f"not below {TOL_FOURTH[label]:g}")
    if not resid <= GMRES_TOL:
        raise RuntimeError(f"fourth {label} annular GMRES residual "
                           f"{resid:.3e} > {GMRES_TOL}")
    if launches[kname] <= 0:
        raise RuntimeError(f"the fourth {label} solve launched no {kname} "
                           "kernel")
    report_backend(f"fourth {label}", "fft", setup_s, first_s, warm, run)
    return launches, hold_distinct_launches(f"fourth {label}", run, *held)


def fourth_phase(K, SK, counters):
    """solver_type="fourth" on phase 2's Poisson collection and phase 5's
    stokes_3body collection (fft grid backend); returns (launches by
    kernel, max abs difference from the plain version by kernel)."""
    from ipde_tpu_torch.solvers.bie import DirichletBIE, StokesDirichletBIE
    from ipde_tpu_torch.solvers.scalar import PoissonSolver
    from ipde_tpu_torch.solvers.vector import StokesSolver
    launches = {name: 0 for name in counters}
    errs = {name: 0.0 for name in counters}

    ebdyc, f, bc = SHARED["poisson"]
    t0 = time.perf_counter()
    solver = PoissonSolver(ebdyc, solver_type="fourth")
    bie = DirichletBIE(solver)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def poisson_run():
        ue, stats = solver.solve_with_stats(f, tol=GMRES_TOL, maxiter=100,
                                            restart=30)
        ue = bie.apply_bc(ue, bc)
        torch.cuda.synchronize()
        return ue, stats

    def poisson_check(ue):
        g, r = max_err(ebdyc, ue, sol)
        return max(g, r), (f"max error {max(g, r):.10e} (grid {g:.3e}, "
                           f"radial {r:.3e})")

    got, errs["laplace_slp"] = fourth_run(
        "poisson", setup_s, poisson_run, poisson_check, counters,
        "laplace_slp",
        (K, "laplace_slp_apply", K.laplace_slp_apply_plain, laplace_err,
         lambda sx, sy, w, tx, ty: bound_ms("laplace_slp", sx.shape[0],
                                            tx.shape[0])),
        f"phase 2's spectral [fft] error on this collection "
        f"{SHARED['poisson_fft_err']:.4e}")
    for name, n in got.items():
        launches[name] += n

    ebdyc, ((fu, fv), bcs) = SHARED["stokes_3body"]
    t0 = time.perf_counter()
    solver = StokesSolver(ebdyc, solver_type="fourth")
    bie = StokesDirichletBIE(solver)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def stokes_run():
        (u, v, p), stats = solver.solve_with_stats(
            fu, fv, tol=GMRES_TOL, maxiter=100, restart=30)
        out = bie.apply_bc(u, v, p, *bcs)
        torch.cuda.synchronize()
        return out, stats

    def stokes_check(out):
        (ug, ur), (vg, vr) = (max_err_all(ebdyc, out[0], usol),
                              max_err_all(ebdyc, out[1], vsol))
        err = max(ug, vg, *ur, *vr)
        radial = ", ".join(f"{max(a, b):.3e}" for a, b in zip(ur, vr))
        return err, (f"velocity error {err:.10e} (grid {max(ug, vg):.3e}, "
                     f"radial {radial})")

    got, errs["stokes_slp"] = fourth_run(
        "stokes_3body", setup_s, stokes_run, stokes_check, counters,
        "stokes_slp",
        (SK, "stokes_slp_apply", SK.stokes_slp_apply_plain, stokes_err,
         lambda sx, sy, wfx, wfy, tx, ty: bound_ms(
             "stokes_slp", sx.shape[0], tx.shape[0])),
        f"the spectral solve of phase 5 on this case (ipde_tpu, CPU) "
        f"{IPDE_TPU_STOKES3_CPU['port']:.4e}")
    for name, n in got.items():
        launches[name] += n
    return launches, errs


def periodic_sources():
    """PERIODIC_S sources on star(S, x=pi, y=pi, r=2, a=0.2, f=5) with its
    quadrature weights, then 16 within r_cut of an edge (8) or a corner (8)
    with the weights' mean; N(0, 1) densities times the weights."""
    from ipde_tpu_torch.geometry.curve import star
    bdy = star(PERIODIC_S, x=np.pi, y=np.pi, r=2.0, a=0.2, f=5)
    L = 2 * np.pi
    ex = np.array([0.05, L - 0.06, 2.0, 4.0, 0.1, L - 0.1, 3.0, 5.5,
                   0.04, 0.09, L - 0.05, L - 0.08, 0.06, L - 0.03, 0.11,
                   L - 0.12])
    ey = np.array([1.0, 2.5, 0.07, L - 0.04, 4.5, 5.0, 0.12, L - 0.1,
                   0.05, L - 0.07, 0.03, L - 0.06, 0.1, 0.08, L - 0.11,
                   L - 0.02])
    w = np.r_[bdy.weights, np.full(16, bdy.weights.mean())]
    q = np.random.default_rng(7).standard_normal(w.size) * w
    return np.r_[bdy.x, ex], np.r_[bdy.y, ey], q


def far_mask(sx, sy, n, h, reach=6):
    """(n, n) bool: grid points farther than ``reach`` h from every source
    on the torus (stamped source by source, exact)."""
    near = np.zeros((n, n), bool)
    loc = np.arange(-reach - 1, reach + 2)
    for x, y in zip(sx, sy):
        ii = int(round(x / h)) + loc
        jj = int(round(y / h)) + loc
        i, j = np.nonzero((ii[:, None] * h - x) ** 2
                          + (jj[None, :] * h - y) ** 2 <= (reach * h) ** 2)
        near[np.mod(ii[i], n), np.mod(jj[j], n)] = True
    return ~near


def ewald_laplace(tx, ty, sx, sy, q, L, eta=1.3, nk=18, nimg=1):
    """Zero-mean periodic Laplace potential with the neutralizing
    background by an Ewald sum of another splitting parameter than the
    evaluator's (numpy and scipy on the host); sources and targets in one
    period, so images beyond the nearest 3 x 3 add E1(eta^2 L^2) ~ 1e-31."""
    from scipy.special import exp1
    A = L * L
    out = np.zeros_like(tx)
    for mx in range(-nimg, nimg + 1):
        for my in range(-nimg, nimg + 1):
            dx = tx[:, None] - sx[None, :] + mx * L
            dy = ty[:, None] - sy[None, :] + my * L
            out += (exp1(eta**2 * (dx * dx + dy * dy)) / (4 * np.pi)) @ q
    ks = np.arange(-nk, nk + 1) * (2 * np.pi / L)
    ex = np.exp(-1j * np.outer(ks, sx))
    ey = np.exp(-1j * np.outer(ks, sy))
    rho = (ex[:, None, :] * ey[None, :, :]) @ q            # (nk, nk)
    k2 = ks[:, None] ** 2 + ks[None, :] ** 2
    k2[nk, nk] = np.inf
    coef = np.exp(-k2 / (4 * eta**2)) / k2 / A * rho
    out += np.einsum("ab,ta,tb->t", coef, np.exp(1j * np.outer(tx, ks)),
                     np.exp(1j * np.outer(ty, ks))).real
    return out - q.sum() / (4 * eta**2 * A)


def periodic_phase(dev, K):
    """The periodic evaluator on a PERIODIC_N^2 grid of [0, 2 pi]^2 (see the
    module docstring)."""
    from ipde_tpu_torch.geometry.grid import Grid
    from ipde_tpu_torch.ops.grid_eval import (FreespaceGridEvaluator,
                                              PeriodicGridEvaluator)
    t_phase = time.perf_counter()
    L, n = 2 * np.pi, PERIODIC_N
    h = L / n
    grid = Grid((0.0, L), n, (0.0, L), n)
    sx, sy, q = periodic_sources()
    qd = torch.as_tensor(q, device=dev)
    far = far_mask(sx, sy, n, h)
    r_cut = 22.0 * h
    n_edge = int((np.minimum.reduce([sx, L - sx, sy, L - sy]) < r_cut).sum())
    print(f"# periodic: grid {n}x{n}, {sx.size} sources ({n_edge} within "
          f"r_cut {r_cut:.4f} of an edge), {int(far.sum())} grid points "
          f"farther than 6 h from every source", flush=True)
    gaps = []
    for kernel in ("yukawa", "laplace"):
        t0 = time.perf_counter()
        ev = PeriodicGridEvaluator(grid, sx, sy, kernel=kernel,
                                   kappa=PERIODIC_KAPPA, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        charges = ([("", qd)] if kernel == "yukawa" else
                   [("non-neutral", qd), ("neutral", qd - qd.mean())])
        for tag, c in charges:
            a, b = ev(c), ev(c)
            torch.cuda.synchronize()
            equal = torch.equal(a, b)
            if kernel == "yukawa":
                shifts = [(mx * L, my * L) for mx in (-1, 0, 1)
                          for my in (-1, 0, 1)]
                t = lambda v: torch.as_tensor(v, device=dev)  # noqa: E731
                isx = t(np.concatenate([sx + u for u, _ in shifts]))
                isy = t(np.concatenate([sy + v for _, v in shifts]))
                iq = c.repeat(9)
                txy = [t(g.reshape(-1)) for g in (grid.xg, grid.yg)]
                want = K.mh_slp_apply(isx, isy, iq, *txy, PERIODIC_KAPPA)
                torch.cuda.synchronize()
                d = (a.reshape(-1) - want).abs().cpu().numpy().reshape(n, n)
                gap, gap_all = float(d[far].max()), float(d.max())
                what = (f"against the mh_slp sum over 3 x 3 image shifts "
                        f"({isx.shape[0]} sources) at the {int(far.sum())} "
                        f"far points {gap:.3e}, at all {n * n} points "
                        f"{gap_all:.3e}")
            else:
                idx = np.flatnonzero(far.ravel())[::int(far.sum()) // 240]
                ti, tj = np.unravel_index(idx, far.shape)
                want = ewald_laplace(ti * h, tj * h, sx, sy,
                                     c.cpu().numpy(), L)
                gap = float(np.abs(a.cpu().numpy()[ti, tj] - want).max())
                what = (f"against an independent Ewald sum (eta 1.3) at "
                        f"{idx.size} far points {gap:.3e}")
            gaps.append(gap)
            print(f"# periodic {kernel} {tag}: setup {setup_s:.2f} s; "
                  f"{what} (limit {TOL_PERIODIC:.0e}); two runs "
                  f"{'bit-equal' if equal else 'NOT bit-equal'}", flush=True)
            if not (equal and gap <= TOL_PERIODIC):
                raise RuntimeError(f"periodic {kernel} {tag}: error "
                                   f"{gap:.3e} or runs differ")
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            ev(qd)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        print(f"# periodic {kernel}: apply {warm_text(warm)}", flush=True)
    t0 = time.perf_counter()
    fev = FreespaceGridEvaluator(grid, sx, sy, kernel="laplace", device=dev)
    torch.cuda.synchronize()
    fs_setup = time.perf_counter() - t0
    fev(qd)
    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        fev(qd)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"# periodic: beside it FreespaceGridEvaluator (laplace) on the "
          f"same sources and grid: padded box {fev.Px}x{fev.Py}, setup "
          f"{fs_setup:.2f} s, apply {warm_text(warm)}; phase "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)


def ledger_tpu_err(block, **key):
    """The err of the row of LEDGER_TPU.json's ``block`` whose fields equal
    ``key``, as text ("none" where there is no such row)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "LEDGER_TPU.json")
    with open(path) as fh:
        rows = json.load(fh).get(block, {}).get("rows", [])
    row = next((r for r in rows
                if all(r.get(k) == v for k, v in key.items())), None)
    return "none" if row is None else f"{row['err']:.7e}"


def load_example(name):
    """examples/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(K, SK, counters):
    """The smallest default row of four example scripts through their own
    run_case on the card, and entry(): each run with every count set to 0
    just before and read just after, and every launch of it recorded; after
    the run, each distinct (T, S) held to the plain version, timed beside
    its bound, two runs bit for bit (hold_calls).  Returns (launches by
    kernel, max abs difference from the plain version by kernel)."""
    from ipde_tpu_torch.entry import entry, sol as entry_sol
    holds = kernel_holds(K, SK)
    launches = {name: 0 for name in counters}
    errs = {name: 0.0 for name in counters}

    def counted(label, fn):
        for c in counters.values():
            c.launches = 0
        out, calls = record_all_launch_args(fn, holds)
        for name, c in counters.items():
            launches[name] += c.launches
        for name, got in calls.items():
            if len(got) != counters[name].launches:
                raise RuntimeError(f"{label}: {len(got)} {name} launches "
                                   f"recorded, {counters[name].launches} "
                                   "counted")
            if got:
                module, attr, plain, err, bound_of = holds[name]
                errs[name] = max(errs[name], hold_calls(
                    label, got, getattr(module, attr), plain, err, bound_of,
                    "its run"))
        return out

    def hold(label, got, ref, ledger):
        gap = abs(got / ref - 1.0)
        print(f"# example {label}: err {got:.10e}, ipde_tpu on the CPU "
              f"{ref:.10e} (relative difference {gap:.3e}, limit "
              f"{TOL_EXAMPLE_REL}); LEDGER_TPU.json {ledger}", flush=True)
        if not (math.isfinite(got) and gap <= TOL_EXAMPLE_REL):
            raise RuntimeError(f"example {label}: {got:.6e} is not within "
                               f"{TOL_EXAMPLE_REL} of ipde_tpu's {ref:.6e}")

    def times(row):
        return (f"setup {row['setup_s']:.2f} s, first {row['first_s']:.3f} "
                f"s, warm median {row['solve_ms']:.2f} ms (min "
                f"{row['solve_ms_min']:.2f}, max {row['solve_ms_max']:.2f}), "
                f"GMRES {row['iterations']}, residual {row['residual']:.3e} "
                f"at tol {row['tol']:.0e}")

    ex = load_example("torch_poisson_refinement")
    label = "torch_poisson_refinement (200, 8)"
    row = counted(label, lambda: ex.run_case(200, 8))
    old = ledger_tpu_err("poisson_refinement@cpu", nb=200, M=8)
    print(f"# example {label}: {times(row)}; rule err <= 3 x "
          f"{ex.REFERENCE_ERR[200]:.4e} "
          f"{'met' if ex.check(row) else 'NOT met'}", flush=True)
    hold(label, row["err"], IPDE_TPU_EXAMPLES_CPU["poisson_refinement"],
         f"poisson_refinement@cpu {old}")
    if not row["beats_reference"] or launches["laplace_slp"] <= 0:
        raise RuntimeError(f"{label} misses its rule or launched no "
                           "laplace_slp")

    ex = load_example("torch_mh_neumann_refinement")
    label = "torch_mh_neumann_refinement (k = 1: 200, 10)"
    before = launches["mh_slp"]
    row = counted(label, lambda: ex.run_case(1.0, 200, 10))
    old = ledger_tpu_err("mh_neumann_refinement", k2=1.0, nb=200, M=10)
    print(f"# example {label}: {times(row)}; its rule holds the best row of "
          f"each k of a sweep to 3 x {ex.REFERENCE_ERR[1.0]:.2e}: this "
          f"coarse row alone "
          f"{'meets' if row['err'] <= 3 * ex.REFERENCE_ERR[1.0] else 'does not meet'} "
          f"it (the full sweep: PERF.md section 5)", flush=True)
    hold(label, row["err"], IPDE_TPU_EXAMPLES_CPU["mh_neumann_refinement"],
         f"mh_neumann_refinement (cpu block) {old}")
    if launches["mh_slp"] <= before:
        raise RuntimeError(f"{label} launched no mh_slp")

    ex = load_example("torch_stokes_refinement")
    label = "torch_stokes_refinement (100, 8)"
    row = counted(label, lambda: ex.run_case(100, 8))
    old = ledger_tpu_err("stokes_refinement@cpu", nb=100, M=8)
    ok = ex.check(row)
    print(f"# example {label}: {times(row)}; rule err <= 3 x "
          f"{ex.REFERENCE_ERR[100]:.4e} {'met' if ok else 'NOT met'}",
          flush=True)
    hold(f"{label} (ipde_tpu with the port's BIE radial plans)", row["err"],
         IPDE_TPU_EXAMPLES_CPU["stokes_refinement"],
         f"stokes_refinement@cpu (ipde_tpu's own plans) {old}")
    if not ok or launches["stokes_slp"] <= 0:
        raise RuntimeError(f"{label} misses its rule or launched no "
                           "stokes_slp")

    ex = load_example("torch_advection_convergence")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "LEDGER_TPU.json")) as fh:
        adv = json.load(fh)["advection_convergence"]
    adv = next(r for r in adv["rows"] if r["dt"] == 0.1)
    for order2, scheme in ((False, "fe"), (True, "bdf2")):
        label = f"torch_advection_convergence {scheme}"
        err, step_s = counted(label,
                              lambda: ex.run_case(0.1, 2, order2, 200, 10))
        print(f"# example {label} (dt 0.1, 2 steps, nb 200, M 10): "
              f"{step_s:.3f} s per step", flush=True)
        hold(label, err,
             IPDE_TPU_EXAMPLES_CPU[f"advection_convergence_{scheme}"],
             f"advection_convergence (cpu block, nb 200, M 10, T 0.2) "
             f"{adv['err_' + scheme]:.4e}")

    fn, args = entry()
    t0 = time.perf_counter()
    u = counted("entry()", lambda: fn(*args))
    torch.cuda.synchronize()
    ebdyc = fn.solver.ebdyc
    g = ebdyc.grid
    err = float(np.abs(u.cpu().numpy() - entry_sol(g.xg, g.yg))
                [ebdyc.phys].max())
    print(f"# entry(): one fn(*args) on the card, its kernels held after "
          f"it, {time.perf_counter() - t0:.3f} s, grid {tuple(u.shape)}, max "
          f"error against the analytic solution {err:.4e}", flush=True)
    if not (math.isfinite(err) and err < 2e-6):
        raise RuntimeError(f"entry(): error {err:.3e}")
    return launches, errs


def phase7(dev, K, SK, counters):
    """Phase 7 (see the module docstring); returns (launches by kernel, max
    abs difference from the plain version by kernel)."""
    t_phase = time.perf_counter()
    launches, errs = fourth_phase(K, SK, counters)
    periodic_phase(dev, K)
    got, held = examples_phase(K, SK, counters)
    for name, n in got.items():
        launches[name] += n
        errs[name] = max(errs[name], held[name])
    print(f"# phase 7 {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches, errs


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

    # ---- phases 2-5: each main path, its kernels held to the plain -------
    kernels = [*poisson_phase(dev, K, counters),
               stokes_phase(dev, SK, counters),
               mh_phase(dev, K, counters)]
    launches, errs = multi_body_phase(dev, K, SK, counters)
    # ---- phase 6: the moving-boundary path --------------------------------
    stepper_launches, stepper_err = stepper_phase(dev, K, counters)
    launches["mh_slp"] += stepper_launches
    errs["mh_slp"] = max(errs["mh_slp"], stepper_err)
    advector_phase(dev)
    tier2_interface_phase(dev)
    # ---- phase 7: fourth order, the periodic evaluator, the examples ------
    fourth_launches, fourth_errs = phase7(dev, K, SK, counters)
    for name, n in fourth_launches.items():
        launches[name] += n
        errs[name] = max(errs[name], fourth_errs.get(name, 0.0))
    for entry in kernels:
        entry["launches"] += launches[entry["name"]]
        entry["max_abs_err"] = max(entry["max_abs_err"], errs[entry["name"]])

    # ---- phase 8: results --------------------------------------------------
    print(f"# total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
