"""Phase timers and device tracing (ipde_tpu.utils.profiling on torch;
reference analogue: the time.time() blocks in
examples/poisson_for_paper.py:60-104).

CUDA work is asynchronous: ``Timer`` synchronizes the card at the end of a
phase when the phase's result lies on it, so the time is the phase's and
not the launch's.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict

import torch


def _tensors(x):
    """The tensors in a (nested) tuple, list or dict, or in an object with
    ``grid`` and ``radials`` (an EmbeddedFunction)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "grid") and hasattr(x, "radials"):
        yield from _tensors([x.grid, x.radials])


def sync(x=None):
    """Wait for the card when ``x`` holds a CUDA tensor (or, with x None,
    whenever a card is present)."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    devs = {t.device for t in _tensors(x) if t.is_cuda}
    for d in devs:
        torch.cuda.synchronize(d)


class Timer:
    """Accumulating phase timer.

    with timer("annular", result):
        ...
    print(timer.report())

    ``result``: anything holding the phase's output tensors, synchronized
    at the end of the phase when they lie on the card; a list may be filled
    inside the block.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        sync(result)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(f"{k}: {v * 1e3:.1f} ms ({self.counts[k]}x)"
                         for k, v in sorted(self.totals.items(),
                                            key=lambda kv: -kv[1]))


def time_solves(run, warm: int = 5):
    """Call ``run()`` once and then ``warm`` times more, each call timed on
    the host clock up to the synchronization of its result.  Returns (the
    first call's result, {"first_s": the first call (CUDA library start-up
    included), "solve_ms": the median of the warm calls, "solve_ms_min",
    "solve_ms_max"})."""
    t0 = time.perf_counter()
    out = run()
    sync(out)
    first = time.perf_counter() - t0
    ms = []
    for _ in range(warm):
        t0 = time.perf_counter()
        sync(run())
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, {"first_s": first, "solve_ms": statistics.median(ms),
                 "solve_ms_min": min(ms), "solve_ms_max": max(ms)}


@contextlib.contextmanager
def trace(path: str = "trace.json"):
    """torch.profiler context (CPU, and CUDA where a card is present) that
    writes a Chrome trace to ``path`` when it closes."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(path)
