"""The two grid backends of ipde_tpu_torch side by side on one card: the FFT
evaluators against the dense CUDA kernel they replace, stage by stage, and
the warm solve of each backend in alternating turns.

    python3 tools/torch_backend_compare.py [--problems poisson stokes mh2]
                                           [--pairs 10] [--reps 50]

For each chip_smoke.py problem named (``poisson``: star(1200, a=0.2, f=3),
M=16, DirichletBIE; ``stokes``: bench.py's tier 1; ``mh2``: the k = 2 Yukawa
Dirichlet problem) it builds the dense-backend solver and BIE
(chip_smoke.build_*(backend="dense")) and then the fft-backend ones on the
same collection, printing each setup's seconds.  Then, with CUDA events:
  * each evaluator (the solver's merged sigma_g, the BIE's) held against
    the dense kernel and timed per apply beside the dense kernel at the
    targets it stands in for (the merged apply's pna + interface points;
    the BIE's physical points), by chip_smoke.hold_evaluator;
  * its stages over ``--reps`` launches each, through the evaluator's own
    stage methods: spread (matmul), forward transform, symbol multiply,
    inverse transform (output window), near corrections (CSR product).
Then ``--pairs`` pairs of warm solves (solve_with_stats + apply_bc, host
clock around torch.cuda.synchronize), the order alternating dense, fft /
fft, dense, and prints each backend's median, quartiles, min and max and the
pairs the fft solve won.  Needs a CUDA device; prints the card's name and
power limit first and one JSON line per problem last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stage_ms(ev, qs, reps):
    """ms per call of each stage of one apply of evaluator ``ev`` on the
    (B, S) charges ``qs`` (B = 1 scalar, 2 Stokes): the evaluator's own
    stage methods, in the order its __call__ runs them."""
    from chip_smoke import cuda_ms
    spread = ev._spread(qs)
    spec = ev.fft_plan.rfft2(spread)
    out = ev._multiply(spec)
    q = qs.reshape(-1)
    return {"spread": cuda_ms(lambda: ev._spread(qs), reps),
            "forward": cuda_ms(lambda: ev.fft_plan.rfft2(spread), reps),
            "multiply": cuda_ms(lambda: ev._multiply(spec), reps),
            "inverse": cuda_ms(lambda: ev._inverse(out), reps),
            "corrections": cuda_ms(lambda: ev._patches @ q, reps)}


def compare_evaluator(label, ev, kernel, src, w, phys, replaced, reps,
                      seed=11):
    """chip_smoke.hold_evaluator (the evaluator against the dense kernel at
    the physical points ``phys``, both timed per apply), then the
    evaluator's stages on the same charges; returns a dict of the times."""
    from chip_smoke import hold_evaluator
    stokes = kernel.__name__ == "stokes_slp_apply"
    ev_ms, dense_ms = hold_evaluator(
        label, ev, kernel, src, w, phys,
        (1e-10, 1e-10, 1e-11) if stokes else (1e-12,), replaced, seed=seed)
    rng = np.random.default_rng(seed)
    qs = torch.stack([torch.as_tensor(rng.standard_normal(w.shape[0]),
                                      device=w.device) * w
                      for _ in range(2 if stokes else 1)])
    out = {"evaluator_ms": ev_ms, "dense_ms": dense_ms,
           "stages_ms": stage_ms(ev, qs, reps)}
    print(f"# {label}: spread block {ev.spread_shape[0]}x"
          f"{ev.spread_shape[1]}; stages "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["stages_ms"].items())
          + " ms", flush=True)
    return out


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def main():
    import chip_smoke as cs
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import kernels as K
    from ipde_tpu_torch.ops import stokes_kernels as SK
    from ipde_tpu_torch.solvers.bie import DirichletBIE, StokesDirichletBIE
    from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                               PoissonSolver)
    from ipde_tpu_torch.solvers.vector import StokesSolver

    ap = argparse.ArgumentParser()
    ap.add_argument("--problems", nargs="+", default=["poisson", "stokes",
                                                      "mh2"],
                    choices=("poisson", "stokes", "mh2"))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    kw = dict(tol=cs.GMRES_TOL, maxiter=100, restart=30)
    for name in args.problems:
        t0 = time.perf_counter()
        if name == "stokes":
            ebdyc, _, fs, bcs, dsol, dbie = cs.build_stokes_problem(
                dev, backend="dense")
        elif name == "poisson":
            ebdyc, _, f, bc, dsol, dbie = cs.build_problem(dev,
                                                           backend="dense")
        else:
            _, k, nb, M, _, _ = cs.MH_CASES[0]
            ebdyc, _, f, bc, dsol, dbie = cs.build_mh_problem(
                dev, k, nb, M, "dirichlet", backend="dense")
        torch.cuda.synchronize()
        setup = {"dense_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        if name == "stokes":
            fsol = StokesSolver(ebdyc)
            fbie = StokesDirichletBIE(fsol)
            src = fbie.src_list[0].dev(dev)
            kernel = SK.stokes_slp_apply

            def solve(s, b):
                (u, v, p), _ = s.solve_with_stats(*fs, **kw)
                b.apply_bc(u, v, p, *bcs)
                torch.cuda.synchronize()
        else:
            fsol = (PoissonSolver(ebdyc) if name == "poisson"
                    else ModifiedHelmholtzSolver(ebdyc, k=k))
            fbie = DirichletBIE(fsol)
            src = fbie.src_list[0].dev(dev)
            if name == "poisson":
                kernel = K.laplace_slp_apply
            else:
                def kernel(sx, sy, q, tx, ty):
                    return K.mh_slp_apply(sx, sy, q, tx, ty, k)

            def solve(s, b):
                b.apply_bc(s.solve_with_stats(f, **kw)[0], bc)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        setup["fft_s"] = time.perf_counter() - t0
        print(f"# {name}: setup dense {setup['dense_s']:.2f} s, fft "
              f"{setup['fft_s']:.2f} s (the fft solver and BIE on the dense "
              "problem's collection)", flush=True)
        phys = (dbie.phys_flat, dbie.phys_x, dbie.phys_y)
        evals = {
            "merged": compare_evaluator(
                f"{name} merged sigma_g evaluator", fsol.grid_eval, kernel,
                (fsol.grid_src_x, fsol.grid_src_y), fsol.grid_src_w, phys,
                (dsol._dense_tx, dsol._dense_ty), args.reps),
            "bie": compare_evaluator(
                f"{name} BIE evaluator", fbie.grid_eval, kernel,
                (src["x"], src["y"]), src["weights"], phys, phys[1:],
                args.reps)}
        times = {"dense": [], "fft": []}
        for s, b in ((dsol, dbie), (fsol, fbie)):
            solve(s, b)                       # warm-up
        for i in range(args.pairs):
            order = (("dense", dsol, dbie), ("fft", fsol, fbie))
            for backend, s, b in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                solve(s, b)
                times[backend].append((time.perf_counter() - t0) * 1e3)
        wins = sum(f < d for d, f in zip(times["dense"], times["fft"]))
        summary = {}
        for backend, xs in times.items():
            lo, hi = quartiles(xs)
            summary[backend] = {"median_ms": statistics.median(xs),
                                "q1_ms": lo, "q3_ms": hi,
                                "min_ms": min(xs), "max_ms": max(xs)}
            print(f"# {name} [{backend}] warm solve: median "
                  f"{statistics.median(xs):.2f} ms, quartiles {lo:.2f} / "
                  f"{hi:.2f}, min {min(xs):.2f}, max {max(xs):.2f} "
                  f"({len(xs)} runs, turns alternating)", flush=True)
        print(f"# {name}: the fft solve was faster in {wins} of "
              f"{args.pairs} pairs", flush=True)
        print(json.dumps({"problem": name, "setup": setup,
                          "evaluators": evals, "warm": summary,
                          "fft_wins": wins, "pairs": args.pairs}),
              flush=True)
        del dsol, dbie, fsol, fbie
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
