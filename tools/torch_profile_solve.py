"""Where the time of one ipde_tpu_torch solve goes, on a CUDA GPU.

    python3 tools/torch_profile_solve.py [--pde poisson|stokes] [--nb 1200]
                                         [--M 16] [--reps 3]
                                         [--trace trace.json]

Builds the problem of chip_smoke.py (``--pde poisson``: the interior Poisson
problem, star(nb, a=0.2, f=3); ``--pde stokes``: bench.py's tier-1 interior
Stokes problem, star(nb, a=0.2, f=5) on a grid_target=1024 box), warms it
up, then:
  * times the two halves of a solve (solve_with_stats and apply_bc) on the
    host clock around torch.cuda.synchronize;
  * records the (targets, sources) of every dense-kernel launch of one
    solve;
  * traces ``--reps`` solves with torch.profiler and prints the device time
    by kernel, the device busy time, the idle share of the traced window,
    and the device time of each dense-kernel launch of the first solve
    beside its shape and block count;
  * writes the chrome trace to ``--trace`` when given.
Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def record_launches(run, module, name):
    """Run ``run`` once with ``module.name`` wrapped to record the
    (targets, sources) of each call.  The wrapper counts its launches in
    the attribute of its module-level name, so the stand-in carries it."""
    orig = getattr(module, name)
    shapes = []

    def wrapped(*args):
        shapes.append((args[-1].shape[0], args[0].shape[0]))
        return orig(*args)

    wrapped.launches = orig.launches
    setattr(module, name, wrapped)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
        orig.launches = wrapped.launches
    return shapes


def main():
    from chip_smoke import build_problem, build_stokes_problem
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import kernels, stokes_kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--pde", choices=("poisson", "stokes"), default="poisson")
    ap.add_argument("--nb", type=int, default=1200)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args()
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    kw = dict(tol=1e-12, maxiter=100, restart=30)
    if args.pde == "poisson":
        ebdyc, grid, f, bc, solver, bie = build_problem(dev, args.nb, args.M)
        first = lambda: solver.solve_with_stats(f, **kw)[0]  # noqa: E731
        second = lambda ue: bie.apply_bc(ue, bc)  # noqa: E731
        module, wrapper, kname = kernels, "laplace_slp_apply", "laplace_slp"
    else:
        ebdyc, grid, (fu, fv), (bcu, bcv), solver, bie = \
            build_stokes_problem(dev, args.nb, args.M)
        first = lambda: solver.solve_with_stats(fu, fv, **kw)[0]  # noqa: E731
        second = lambda uvp: bie.apply_bc(*uvp, bcu, bcv)  # noqa: E731
        module, wrapper, kname = stokes_kernels, "stokes_slp_apply", \
            "stokes_slp"

    def halves():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = first()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        second(out)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    for _ in range(2):
        halves()
    runs = [halves() for _ in range(5)]
    print(f"# {args.pde} nb={args.nb} M={args.M} grid {grid.shape}: "
          f"solve_with_stats median "
          f"{statistics.median(r[0] for r in runs) * 1e3:.3f} ms, apply_bc "
          f"median {statistics.median(r[1] for r in runs) * 1e3:.3f} ms "
          f"(5 runs, host clock)")
    shapes = record_launches(lambda: second(first()), module, wrapper)

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            second(first())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) * 1e-6   # us -> s
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    mine = sorted((e for e in events if f"{kname}_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    kbusy = sum(e.device_time_total for e in mine) * 1e-6
    print(f"# traced {args.reps} solves: wall {wall * 1e3:.3f} ms, device "
          f"kernels {busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}, "
          f"{kname}_kernel {kbusy * 1e3:.3f} ms ({100 * kbusy / busy:.2f}% "
          f"of device time) in {len(mine)} launches (profiler on)")
    for i, ((T, S), e) in enumerate(zip(shapes, mine)):
        print(f"#   launch {i}: T={T} S={S} blocks={math.ceil(T / 256)} "
              f"{e.device_time_total * 1e-3:.3f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
