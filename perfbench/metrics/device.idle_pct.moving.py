"""The device's idle share of the untraced window, in %: 100 (1 - device
busy time per call / window time per call).  The busy time is the union of
the device-operation intervals of the traced calls; the window's time per
call is the untraced one, since the profiler lengthens the traced calls'
host time (``harness/trace.py``)."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0.0 or not rec.calls:
        return None
    busy = rec.trace.busy_s / rec.trace.calls
    return 100.0 * (1.0 - busy / (rec.window_s / rec.calls))
