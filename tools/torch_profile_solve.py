"""Where the time of one ipde_tpu_torch solve goes, on a CUDA GPU.

    python3 tools/torch_profile_solve.py [--pde poisson|stokes|mh]
                                         [--k 2|100] [--nb N] [--M M]
                                         [--backend fft|dense]
                                         [--reps 3] [--trace trace.json]

Builds a problem of chip_smoke.py (``--pde poisson``: the interior Poisson
problem, star(nb, a=0.2, f=3), nb=1200, M=16 by default; ``--pde stokes``:
bench.py's tier-1 interior Stokes problem, star(nb, a=0.2, f=5) on a
grid_target=1024 box, the same defaults; ``--pde mh``: the interior modified
Helmholtz problem of chip_smoke.MH_CASES with that ``--k``: k=2 Dirichlet,
star(800, a=0.2, f=5), M=20, or k=100 Neumann, star(600, a=0.2, f=5),
M=24) with grid backend ``--backend`` (default fft, the solvers'
default), warms it up, then:
  * times the two halves of a solve (solve_with_stats and apply_bc) on the
    host clock around torch.cuda.synchronize;
  * records the (targets, sources) of every dense-kernel launch of one
    solve (chip_smoke.record_launch_args), and its bound (chip_smoke.bound_ms; for the Yukawa kernel
    chip_smoke.mh_bound_ms, from the pairs of that launch in each branch);
  * traces ``--reps`` solves with torch.profiler and prints the device time
    by kernel, the device busy time, the idle share of the traced window,
    and the device time of each dense-kernel launch of the first solve
    beside its shape, block count and bound;
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


def launch_times(events, kname):
    """Device microseconds of each apply of the kernel ``kname`` among the
    device events, in time order.  An apply with few targets is two
    kernels, the sum over a range of sources and the one that combines the
    ranges (``combine_splits_kernel``): both count towards the apply, so a
    launch's time stays comparable with a one-kernel version's.  (The
    spatial order of the targets costs no kernel of its own: the solvers
    order the indices they scatter to instead of gathering the outputs.)"""
    times = []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if f"{kname}_kernel" in e.name:
            times.append(e.device_time_total)
        elif "combine_splits_kernel" in e.name and times:
            times[-1] += e.device_time_total
    return times


def main():
    from chip_smoke import (MH_CASES, bound_ms, build_mh_problem,
                            build_problem, build_stokes_problem, mh_bound_ms,
                            record_launch_args)
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import kernels, stokes_kernels

    mh_cases = {case[1]: case for case in MH_CASES}
    ap = argparse.ArgumentParser()
    ap.add_argument("--pde", choices=("poisson", "stokes", "mh"),
                    default="poisson")
    ap.add_argument("--k", type=float, choices=sorted(mh_cases), default=2.0,
                    help="the modified Helmholtz problem (--pde mh)")
    ap.add_argument("--nb", type=int)
    ap.add_argument("--M", type=int)
    ap.add_argument("--backend", choices=("fft", "dense"), default="fft")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args()
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    kw = dict(tol=1e-12, maxiter=100, restart=30)
    if args.pde == "stokes":
        args.nb, args.M = args.nb or 1200, args.M or 16
        ebdyc, grid, (fu, fv), (bcu, bcv), solver, bie = \
            build_stokes_problem(dev, args.nb, args.M,
                                 backend=args.backend)
        first = lambda: solver.solve_with_stats(fu, fv, **kw)[0]  # noqa: E731
        second = lambda uvp: bie.apply_bc(*uvp, bcu, bcv)  # noqa: E731
        module, wrapper, kname = stokes_kernels, "stokes_slp_apply", \
            "stokes_slp"
    else:
        if args.pde == "mh":
            _, k, nb, M, bie_kind, _ = mh_cases[args.k]
            args.nb, args.M = args.nb or nb, args.M or M
            ebdyc, grid, f, bc, solver, bie = build_mh_problem(
                dev, k, args.nb, args.M, bie_kind, backend=args.backend)
            wrapper, kname = "mh_slp_apply", "mh_slp"
        else:
            args.nb, args.M = args.nb or 1200, args.M or 16
            ebdyc, grid, f, bc, solver, bie = build_problem(
                dev, args.nb, args.M, backend=args.backend)
            wrapper, kname = "laplace_slp_apply", "laplace_slp"
        first = lambda: solver.solve_with_stats(f, **kw)[0]  # noqa: E731
        second = lambda ue: bie.apply_bc(ue, bc)  # noqa: E731
        module = kernels

    def bound(sx, *args):
        """(bound ms, bound_by) of one launch with these arguments."""
        if kname == "mh_slp":
            sy, _, tx, ty, k = args
            return mh_bound_ms(sx, sy, tx, ty, k)[:2]
        return bound_ms(kname, sx.shape[0], args[-1].shape[0])

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
    label = f"mh k={args.k:g}" if args.pde == "mh" else args.pde
    label += f" [{args.backend}]"
    print(f"# {label} nb={args.nb} M={args.M} grid {grid.shape}: "
          f"solve_with_stats median "
          f"{statistics.median(r[0] for r in runs) * 1e3:.3f} ms, apply_bc "
          f"median {statistics.median(r[1] for r in runs) * 1e3:.3f} ms "
          f"(5 runs, host clock)")
    shapes = [(next(a for a in reversed(call)
                    if isinstance(a, torch.Tensor)).shape[0],
               call[0].shape[0], bound(*call))
              for call in record_launch_args(lambda: second(first()), module,
                                             wrapper)]

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
    mine = launch_times(events, kname)
    kbusy = sum(mine) * 1e-6
    print(f"# traced {args.reps} solves: wall {wall * 1e3:.3f} ms, device "
          f"kernels {busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}, "
          f"{kname}_kernel {kbusy * 1e3:.3f} ms ({100 * kbusy / busy:.2f}% "
          f"of device time) in {len(mine)} launches (profiler on; a launch "
          f"that splits its sources counts its combining kernel)")
    for i, ((T, S, (bnd, by)), us) in enumerate(zip(shapes, mine)):
        print(f"#   launch {i}: T={T} S={S} target tiles="
              f"{math.ceil(T / 256)} {us * 1e-3:.3f} ms, bound {bnd:.4f} ms "
              f"({by})")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
