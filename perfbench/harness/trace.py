"""What the benchmark reads from a ``torch.profiler`` trace.

The device is busy where any device operation ran: the union of the
intervals of every kernel, copy and set on the card, so work on the shard
and side streams that overlaps is counted once (``chip_smoke.py``'s
``profile_device`` summed the kernel times, which counts it twice).  The
traced window is the benchmark's own ``bench.window`` span; an idle gap is
labelled by the innermost ``bench.*`` span the host was in at the gap's
middle.

The profiler lengthens the host's share of the window: CUPTI's tracing of
every launch costs the replay of a Stokes solve some 6 ms, whether the
host's ops are recorded or not.  Device times (busy, per kernel) stay the
program's own, so the idle shares the benchmark reports hold the traced
busy time against the untraced window (``metrics/device.idle_pct.*``).
``window_s`` stays the traced window."""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge (start, end) intervals; the result is sorted and disjoint."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(busy, lo, hi):
    """The idle (start, end) intervals of [lo, hi] outside ``busy`` (a
    union)."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def label_of(t, spans):
    """The innermost span (name, start, end) that holds time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "outside bench spans"


@dataclass
class Trace:
    """One traced segment: times in nanoseconds on the profiler's clock."""
    window: Tuple[int, int]
    device: List[Tuple[str, int, int]]           # (name, start, end)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    calls: int = 1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        return union(clip([(a, b) for _, a, b in self.device], *self.window))

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_s(self, names) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``, inside the window."""
        picked = [(a, b) for n, a, b in self.device
                  if any(k in n for k in names)]
        return sum(b - a for a, b in clip(picked, *self.window)) * 1e-9

    def top_ops(self, n=10):
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + (b - a) * 1e-9
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_label(self, n=10):
        by: Dict[str, float] = {}
        for a, b in gaps(self.busy_intervals(), *self.window):
            lab = label_of((a + b) // 2, self.spans)
            by[lab] = by.get(lab, 0.0) + (b - a) * 1e-9
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def from_profiler(prof, calls) -> Trace:
    """Read a finished ``torch.profiler.profile`` (CPU and CUDA activities)
    whose traced work ran inside ``record_function("bench.window")``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            # a record_function span is mirrored on the device's timeline:
            # it is an annotation, not an operation
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                device.append((e.name(), a, b))
        elif e.name() == "bench.window":
            window = (a, b)
        elif e.name().startswith("bench."):
            spans.append((e.name()[len("bench."):], a, b))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return Trace(window, device, spans, calls)
