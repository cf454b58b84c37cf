"""The GMRES chunk length (``ipde_tpu_torch/ops/gmres.py::CHUNK``) on one
card: planified solves with each chunk length in alternating turns.

    python3 tools/torch_planify_chunk.py [--problems poisson stokes mh2]
                                         [--chunks 1 2 4 8] [--turns 10]
                                         [--root DIR]

For each chip_smoke.py problem named (``poisson``: star(1200, a=0.2, f=3),
M=16, DirichletBIE; ``stokes``: bench.py's tier 1; ``mh2``: the k = 2
Yukawa Dirichlet problem; all on the fft grid backend) it builds the solver
and BIE once and, for each chunk length, ``planified(solve + apply_bc)``
(captured with that length; the first call's seconds printed).  Then
``--turns`` turns, each running every chunk length once in rotating order,
each solve timed on the host clock up to ``torch.cuda.synchronize()``;
prints per chunk length the median, min and max, the host reads per solve
(``LockstepGmres.host_reads``), the GMRES iterations, and the device ms per
solve of 3 solves traced by torch.profiler.  Also the eager solve in the
same turns.  ``--root DIR`` imports ``ipde_tpu_torch`` from another
checkout (e.g. ``git archive <commit> | tar -x -C build/parent``) with
``--chunks`` and no value: the eager solve of that commit alone, so that
two commits compare in one call (parent, change, change, parent).  Needs a
CUDA device; prints the card's name and power limit first and one JSON line
per problem last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import importlib.util

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This checkout's chip_smoke.py (its builders and profiler helper)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


def problem(name, dev):
    C = smoke()
    if name == "poisson":
        _, _, f, bc, s, b = C.build_problem(dev)
        return s, b, (f, bc)
    if name == "stokes":
        _, _, fs, bcs, s, b = C.build_stokes_problem(dev)
        return s, b, (fs, bcs)
    _, _, f, bc, s, b = C.build_mh_problem(dev, 2.0, 800, 20, "dirichlet")
    return s, b, (f, bc)


def solve_fn(solver, bie, data):
    """(fn(*tensors) -> output tensors, args) of one solve + apply_bc."""
    from ipde_tpu_torch.functions import EmbeddedFunction
    kw = dict(tol=1e-12, maxiter=100, restart=30)
    if isinstance(data[0], tuple):
        (fu, fv), (bu, bv) = data

        def fn(fug, fur, fvg, fvr):
            (u, v, p), st = solver.solve_with_stats(
                EmbeddedFunction(fug, [fur]), EmbeddedFunction(fvg, [fvr]),
                **kw)
            out = bie.apply_bc(u, v, p, bu, bv)
            return [ef.grid for ef in out], st
        return fn, (fu.grid, fu.radials[0], fv.grid, fv.radials[0])
    f, bc = data

    def fn(fg, fr):
        ue, st = solver.solve_with_stats(EmbeddedFunction(fg, [fr]), **kw)
        return [bie.apply_bc(ue, bc).grid], st
    return fn, (f.grid, f.radials[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", nargs="+",
                    default=["poisson", "stokes", "mh2"])
    ap.add_argument("--chunks", nargs="*", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    C = smoke()
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import gmres as G
    dev = require_cuda()
    print(f"# ipde_tpu_torch from {os.path.abspath(args.root)}", flush=True)
    reads_of = getattr(G, "LockstepGmres", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    default = getattr(G, "CHUNK", None)
    for name in args.problems:
        t0 = time.perf_counter()
        solver, bie, data = problem(name, dev)
        fn, fargs = solve_fn(solver, bie, data)
        fn(*fargs)
        torch.cuda.synchronize()
        print(f"# {name}: setup {time.perf_counter() - t0:.2f} s", flush=True)
        runs = {"eager": lambda: fn(*fargs)}
        for c in args.chunks:
            from ipde_tpu_torch.utils.planify import planified
            G.CHUNK = c
            call = planified(fn, solver, bie)
            t0 = time.perf_counter()
            call(*fargs)
            torch.cuda.synchronize()
            print(f"# {name} chunk {c}: first call "
                  f"{time.perf_counter() - t0:.3f} s (capture {call.captured.capture_s:.3f} s, pool "
                  f"{call.captured.pool_bytes / 2**20:.1f} MiB)", flush=True)
            runs[f"chunk {c}"] = lambda call=call: call(*fargs)
        G.CHUNK = default
        keys = list(runs)
        times = {k: [] for k in keys}
        for t in range(args.turns):
            for k in keys[t % len(keys):] + keys[:t % len(keys)]:
                t0 = time.perf_counter()
                runs[k]()
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
        result = {"problem": name, "card": torch.cuda.get_device_name(0)}
        for k in keys:
            r0 = reads_of.host_reads if reads_of else 0
            _, st = runs[k]()
            reads = (reads_of.host_reads - r0) if reads_of else None
            _, busy, idle = C.profile_device(runs[k])
            ms = times[k]
            result[k] = {"median_ms": statistics.median(ms),
                         "min_ms": min(ms), "max_ms": max(ms),
                         "host_reads": reads, "device_ms": busy,
                         "idle_share": idle,
                         "iterations": [int(i) for i in
                                        st["annular_iterations"]]}
            print(f"# {name} {k}: warm {statistics.median(ms):.3f} ms (min "
                  f"{min(ms):.3f}, max {max(ms):.3f}, {len(ms)} turns), host "
                  f"reads {reads}, iterations {result[k]['iterations']}, "
                  f"device {busy:.3f} ms, idle share {idle:.3f}", flush=True)
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
