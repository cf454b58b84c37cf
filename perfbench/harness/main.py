"""One run of one cell: set up, warm, measure, trace, check, print.

``main(argv)`` does what ``run.py`` documents.  With ``allow_cpu`` (the
tests) it runs on the CPU and does not ask for a card; nothing else
differs, so a test drives the rest of a real run."""

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from perfbench.harness import check, problem, spec, trace, window
from perfbench.harness.planstep import plan_step
from perfbench.harness.traffic import Schedule

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "ipde_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``ipde_tpu_torch`` is not ``ipde_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Record:
    """What the metric readers read: ``setup_s``, ``window_s``,
    ``latencies`` (s, one per call of the window), ``calls``, ``spans``
    (name -> [s per call]), ``counters``, ``trace`` (``trace.Trace`` or
    None), ``cfg`` and ``traffic``."""

    def __init__(self, cell):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.setup_s = self.window_s = 0.0
        self.latencies, self.calls = [], 0
        self.spans, self.counters, self.trace = {}, {}, None


class Runner:
    """The program's objects and the cell's calls."""

    def __init__(self, cell, seed, dev):
        import torch
        self.torch = torch
        self.cell, self.cfg, self.eq = cell, cell.cfg, cell.equation
        self.dev = dev
        self.schedule = Schedule(cell.traffic, self.eq, seed)
        self.gmres = dict(self.cfg["gmres"])
        self.stats, self.failed, self.errors = [], 0, []
        self.spans = {}
        self.tracing = False
        self.misses, self.miss_log = 0, []
        self.pad = cell.traffic.get("pad_quantum")

    # -- helpers --------------------------------------------------------
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def span(self, name, timed=True):
        """A ``bench.<name>`` span of the trace; ``timed``: also a span of
        the window, ended by synchronize."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            yield
            if timed:
                self.sync()
        if timed and not self.tracing:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def _step_fn(self, solver, bie):
        return plan_step(solver, bie, self.eq.FORCING, self.eq.BOUNDARY,
                         self.gmres)

    # -- set-up ---------------------------------------------------------
    def setup(self):
        """Build, draw the inputs, capture and warm; ``setup_parts`` holds
        the seconds of each, each ended by synchronize."""
        t = [time.perf_counter()]

        def mark():
            self.sync()
            t.append(time.perf_counter())
        self.geo0 = problem.Geometry(self.cfg, self.dev,
                                     pad_quantum=self.pad)
        mark()
        self.solver, self.bie = problem.solve_objects(self.cfg, self.geo0)
        mark()
        if not self.schedule.moves:
            self.bank_args = [problem.inputs(self.eq, p, self.geo0)
                              for p in self.schedule.bank]
        mark()
        self.call = problem.plan(self._step_fn(self.solver, self.bie),
                                 self.solver, self.bie)
        # the capture, on a card
        self.call(*problem.inputs(self.eq, self.schedule.bank[0], self.geo0))
        mark()
        for i in range(int(self.cell.traffic["warm_calls"])):
            self.step(i)
        mark()
        self.setup_parts = dict(zip(
            ("geometry", "solver_bie", "inputs", "capture", "warm"),
            (b - a for a, b in zip(t, t[1:]))))

    # -- one call -------------------------------------------------------
    def step(self, i):
        if self.schedule.moves:
            return self._moving(i)
        idx = self.schedule.rhs(i)
        with self.span("replay", timed=False):
            out = self.call(*self.bank_args[idx])
        with self.span("output_ready", timed=False):
            self.sync()
        return idx, 0.0, out

    def _moving(self, i):
        rot = self.schedule.rot()
        idx = self.schedule.rhs(i)
        with self.span("geometry"):
            geo = problem.Geometry(self.cfg, self.dev, rot, base=self.geo0,
                                   pad_quantum=self.pad)
        with self.span("setup"):
            solver, bie = problem.solve_objects(self.cfg, geo)
        with self.span("inputs"):
            args = problem.inputs(self.eq, self.schedule.bank[idx], geo)
        out, missed = None, None
        with self.span("replan"):
            try:
                problem.replan(self.call, solver, bie)
            except ValueError as e:
                missed = str(e)
            if missed is not None:
                # a plan shape miss: capture again, as the stepper does.  The
                # old call's graphs, pool and side-stream blocks go first: a
                # planified call is a reference cycle that only the cyclic
                # collector frees, and its pool stays reserved until emptied
                self.misses += 1
                self.miss_log.append(missed)
                self.call = None
                gc.collect()
                if self.dev.type == "cuda":
                    self.torch.cuda.empty_cache()
                self.call = problem.plan(self._step_fn(solver, bie),
                                         solver, bie)
                out = self.call(*args)
        with self.span("solve"):
            if out is None:
                out = self.call(*args)
        return idx, rot, out

    def window_call(self, i):
        try:
            idx, rot, (flat, st) = self.step(i)
        except Exception as e:           # a call that gives no answer
            self.failed += 1
            self.errors.append(f"call {i}: {type(e).__name__}: {e}")
            self.sync()
            return
        self.stats.append(st)
        self.schedule.keep(i, (i, idx, rot, flat))

    def traced(self, first, n):
        """``n`` calls under torch.profiler, after the window."""
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self.tracing = True
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                for j in range(n):
                    self.step(first + j)
                self.sync()
        self.tracing = False
        return trace.from_profiler(prof, n)

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("call", "solver", "bie", "geo0", "bank_args"):
            if hasattr(self, name):
                delattr(self, name)
        self.stats = []
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


def card_power_limit(dev):
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, t_start=None, allow_cpu=False, root=ROOT,
         bench_dir=spec.BENCH_DIR):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = spec.resolve(root, args.workload, bench_dir)
    # the set-up backend the configuration states (the BIEs follow it);
    # the program builds its kernels into build/ inside the checkout
    os.environ["IPDE_QFS_BACKEND"] = cell.cfg["setup_backend"]
    import torch
    if allow_cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            _say(f"perfbench: {args.workload} needs {cell.chips} CUDA "
                 f"card(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda", 0)
    from ipde_tpu_torch.ops.gmres import LockstepGmres
    from ipde_tpu_torch.utils.build import BUILD_DIR
    libs = set(BUILD_DIR.glob("*.so")) if BUILD_DIR.exists() else set()

    t_import = time.perf_counter() - t_start
    run = Runner(cell, args.seed, dev)
    run.setup()
    rec = Record(cell)
    rec.setup_s = time.perf_counter() - t_start
    built = len(set(BUILD_DIR.glob("*.so")) - libs) if BUILD_DIR.exists() \
        else 0
    _say(f"# set-up {rec.setup_s:.3f} s, native libraries built in this "
         f"run: {built}; parts (s): imports and card {t_import:.3f}, "
         + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items()))

    reads0, misses0 = LockstepGmres.host_reads, run.misses
    rec.window_s, rec.latencies = window.closed_loop(run.window_call,
                                                     args.seconds)
    rec.calls = len(rec.latencies)
    rec.spans = run.spans
    rec.counters = {
        "host_reads": LockstepGmres.host_reads - reads0,
        "gmres_iters": sum(int(t) for st in run.stats
                           for t in st["annular_iterations"]),
        "replan_misses": run.misses - misses0,
        "completed": rec.calls - run.failed}
    if rec.counters["replan_misses"]:
        _say(f"# replan shape misses in the window: "
             f"{rec.counters['replan_misses']} of {rec.calls} calls; the "
             f"last: {run.miss_log[-1][:600]}")
    if rec.spans:
        _say("# spans per call (ms): " + ", ".join(
            f"{k} {1e3 * sum(v) / len(v):.1f}" for k, v in rec.spans.items()))
    for e in run.errors[:5]:
        _say(f"# failed {e[:400]}")
    if args.trace:
        rec.trace = run.traced(rec.calls, int(cell.traffic["trace_calls"]))
        _say("# ms a call: untraced window "
             f"{1e3 * rec.window_s / max(rec.calls, 1):.3f}, traced window "
             f"{1e3 * rec.trace.window_s / rec.trace.calls:.3f}, device busy "
             f"in it {1e3 * rec.trace.busy_s / rec.trace.calls:.3f}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        _say(f"# memory: peak allocated {peak}, reserved now "
             f"{torch.cuda.memory_reserved(dev)}, allocated now "
             f"{torch.cuda.memory_allocated(dev)}")

    kept = [(i, idx, rot, check.as_fields(
        cell.equation, [t.detach().cpu().numpy() for t in flat]))
        for i, idx, rot, flat in run.schedule.kept]
    bank = run.schedule.bank
    attempted, failed = rec.calls, run.failed
    run.release()
    del run

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = cell.reader(m).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_ref = time.perf_counter()
    worst = check.worst_errors(cell, bank, kept)
    correct, checks = check.verdict(cell, worst, attempted, failed, kept)
    _say(f"# reference over {len(kept)} kept outputs: "
         f"{time.perf_counter() - t_ref:.2f} s")

    found = forbidden_modules()
    if found:
        _say(f"perfbench: modules of JAX or the JAX package are loaded: "
             f"{found}")
        return 3

    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": cell.chips if dev.type == "cuda" else 0,
              "memory_peak_bytes": int(peak),
              "power_limit": card_power_limit(dev)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(),
                               "idle_gaps": rec.trace.idle_by_label()}
    result["checks"] = checks
    for name, c in checks.items():
        _say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
