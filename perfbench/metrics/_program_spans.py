"""The program's own spans and counters in the traced segment, shared by
the readers of the parts of a moving step and of a replay.

``ipde_tpu_torch/utils/profiling.py`` records spans and counters while
``torch.profiler`` runs, each span with its parent and its start and end on
the trace's clock (Unix-epoch ns).  A reader takes the spans whose start
lies inside the traced window and the counts, without draining them, and
divides by the traced calls.

A part (``PARTS``) is a span name and its dotted children.  Each instant of
the window belongs to the innermost span open then; its part is that span's
part, else its nearest ancestor's.  So a part's time leaves out the spans
of another part nested in it: ``setup.qfs`` inside ``setup.bie`` counts as
QFS, not BIE.

Every reader returns None where the run holds no traced segment, or where
the program records nothing (a checkout whose program has no ``take``)."""

from perfbench.harness.trace import clip, union

PARTS = ("geometry.coords", "geometry.masks", "geometry.plans",
         "setup.annular", "setup.qfs", "setup.evaluators",
         "setup.radial_plans", "setup.bie", "planify.capture")


def traced(rec):
    """(the program's spans that start inside the traced window, its
    counts), or None."""
    if rec.trace is None:
        return None
    try:
        from ipde_tpu_torch.utils import profiling
    except ImportError:
        return None
    take = getattr(profiling, "take", None)
    if take is None:
        return None
    got = take(clear=False)
    lo, hi = rec.trace.window
    return [s for s in got.spans if lo <= s.start_ns <= hi], got.counts


def _part(name):
    for p in PARTS:
        if name == p or name.startswith(p + "."):
            return p
    return None


def part_ms(rec, part):
    """ms per traced call in ``part`` (one of ``PARTS``)."""
    got = traced(rec)
    if got is None:
        return None
    spans = got[0]
    by_id = {s.id: s for s in spans}
    inner = {}
    for s in spans:
        if s.parent in by_id:
            inner[s.parent] = inner.get(s.parent, 0) + s.end_ns - s.start_ns
    owner = {}

    def own(s):
        if s.id not in owner:
            p = _part(s.name)
            if p is None and s.parent in by_id:
                p = own(by_id[s.parent])
            owner[s.id] = p
        return owner[s.id]
    ns = sum(s.end_ns - s.start_ns - inner.get(s.id, 0) for s in spans
             if own(s) == part)
    return 1e-6 * ns / rec.trace.calls


def span_ms(rec, name):
    """ms per traced call in the spans called ``name`` (which nest in no
    other span of that name)."""
    got = traced(rec)
    if got is None:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in got[0]
                      if s.name == name) / rec.trace.calls


def per_call(rec, counter):
    """The program's counter ``counter`` per traced call."""
    got = traced(rec)
    if got is None:
        return None
    return got[1].get(counter, 0) / rec.trace.calls


def busy_pct(rec, prefix):
    """% of the time inside the union of the spans ``prefix`` and
    ``prefix.*`` during which the device was busy (the trace's busy
    intervals); 0 where the trace holds no device operation (a CPU run)."""
    got = traced(rec)
    if got is None:
        return None
    inside = union([(s.start_ns, s.end_ns) for s in got[0]
                    if s.name == prefix or s.name.startswith(prefix + ".")])
    total = sum(b - a for a, b in inside)
    if total <= 0:
        return None
    busy = rec.trace.busy_intervals()
    ns = sum(d - c for a, b in inside for c, d in clip(busy, a, b))
    return 100.0 * ns / total
