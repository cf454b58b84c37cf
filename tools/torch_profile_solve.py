"""Where the time of one ipde_tpu_torch Poisson solve goes, on a CUDA GPU.

    python3 tools/torch_profile_solve.py [--nb 1200] [--M 16] [--reps 3]
                                         [--trace trace.json]

Builds the nb=1200, M=16 interior Poisson problem of chip_smoke.py, warms
it up, then:
  * times the two halves of a solve (PoissonSolver.solve_with_stats and
    DirichletBIE.apply_bc) on the host clock around torch.cuda.synchronize;
  * traces ``--reps`` solves with torch.profiler and prints the device time
    by kernel, the device busy time and the idle share of the traced window;
  * writes the chrome trace to ``--trace`` when given.
Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    from chip_smoke import build_problem
    from ipde_tpu_torch.config import require_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=1200)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args()
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    ebdyc, grid, f, bc, solver, bie = build_problem(dev, args.nb, args.M)
    kw = dict(tol=1e-12, maxiter=100, restart=30)

    def halves():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ue, _ = solver.solve_with_stats(f, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bie.apply_bc(ue, bc)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    for _ in range(2):
        halves()
    runs = [halves() for _ in range(5)]
    print(f"# nb={args.nb} M={args.M} grid {grid.shape}: solve_with_stats "
          f"median {statistics.median(r[0] for r in runs) * 1e3:.3f} ms, "
          f"apply_bc median {statistics.median(r[1] for r in runs) * 1e3:.3f}"
          f" ms (5 runs, host clock)")

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            ue, _ = solver.solve_with_stats(f, **kw)
            bie.apply_bc(ue, bc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) * 1e-6   # us -> s
    print(f"# traced {args.reps} solves: wall {wall * 1e3:.3f} ms, device "
          f"kernels {busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f} "
          f"(profiler on)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
