"""Spans and counters on the profiler's clock, and the timing helpers of the
example drivers (ipde_tpu.utils.profiling on torch; reference analogue: the
time.time() blocks in examples/poisson_for_paper.py:60-104).

``span(name)`` times a stretch of host code and ``count(name, n)`` adds to
a counter.  They record while a ``torch.profiler`` profile runs on this
thread, or inside ``with recording():``; otherwise each costs one check and
records nothing: no clock read, no allocation.  A recorded span keeps its
name, its parent (the recorded span open around it) and its start and end
in Unix-epoch ns as ``time.time_ns()`` reads them, the clock of the
profiler's trace, so spans lie on one timeline with the device's
operations there; under the profiler each also enters
``torch.profiler.record_function``, so the trace holds it as an event.  No
span synchronizes the card: a span times the host, and what the device did
inside it is the trace's.  ``take()`` returns what was recorded.

The port's spans (parent > children) and counters:

  geometry.boundary        ``EmbeddedBoundary()``: radial grid, QFS curves
  geometry.register        a collection's ``register_grid``
    > geometry.coords      each boundary's near points (native/coords.cpp)
    > geometry.masks       masks, point sets, their device copies, box FFT
    > geometry.plans       interface and radial-to-grid interpolation plans
  setup.solver             the Poisson / Yukawa / Stokes solver constructors
    > setup.annular        annular solvers and their operators
    > setup.qfs            the QFS maps (forms and their composition)
    > setup.evaluators     the FFT grid evaluators and their tables
    > setup.radial_plans   stratified source-to-radial-grid plans
  setup.bie                the BIE constructors (and the parts above)
    > setup.bie.invert     the inverse of the BIE system
  setup.self_forms         the host-built Yukawa self forms
                           (``ops/singular.py``), inside setup.qfs or
                           setup.bie; no part of its own, so its time stays
                           in the enclosing part
  planify.capture          a planified call's first call on a card
    > planify.warmup       its eager run
    > planify.record       the capture of its graphs
  planify.replan           ``replan``
  planify.replay           one replay of a captured call
    > gmres.read           the host's wait for a GMRES status read
  planify.graphs (count)   graphs replayed
  interp.phase_entries (count)  entries of the interpolation plans' phase
                           matrices built (``ops/interp.py::phase_matrix``)
  stratified.search_pairs (count)  (target, source) pairs of the distance
                           searches that set the radial plans' strides
                           (``ops/stratified.py``), on the plans' device;
                           0 for a plan whose rows cannot subsample
  plan.capacity_overflow (count)  plan tensors of a padded registration
                           whose used size passed their capacity
                           (``utils/planify.py::capacity``): each one a
                           certain ``replan`` miss
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import statistics
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

_profiler_on = torch._C._autograd._profiler_enabled

_forced = 0                 # depth of ``recording()`` blocks
_ids = itertools.count(1)
_open: List[int] = []       # ids of the recorded spans open now
_spans: list = []           # closed spans, in the order they closed
_counts: Dict[str, int] = {}


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]   # id of the recorded span open around it
    start_ns: int           # Unix-epoch ns, the profiler trace's clock
    end_ns: int


class Recorded(NamedTuple):
    spans: List[Span]
    counts: Dict[str, int]


class _Span:
    __slots__ = ("name", "id", "parent", "start", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.start = time.time_ns()
        # the trace's own event of the span (no profiler, no trace).  Its
        # entry takes some 10-100 us under the profiler and stamps the
        # event about halfway through; its exit stamps near its end
        self.rf = record_function(self.name) if _profiler_on() else None
        if self.rf is not None:
            self.rf.__enter__()
            self.start = (self.start + time.time_ns()) // 2

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        _open.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.start, end))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records the block as a span while recording is
    on (see the module docstring); a shared no-op otherwise."""
    if _forced or _profiler_on():
        return _Span(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function is a ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _forced or _profiler_on():
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _forced or _profiler_on():
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with no profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def take(clear: bool = True) -> Recorded:
    """The spans closed and the counts added since the last ``take``;
    ``clear=False`` leaves them to be taken again."""
    out = Recorded(list(_spans), dict(_counts))
    if clear:
        _spans.clear()
        _counts.clear()
    return out


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
