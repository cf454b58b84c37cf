"""Device-busy ms per traced call: the union of the intervals in which any
operation ran on the card, over the traced window."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0.0:
        return None
    return 1e3 * rec.trace.busy_s / rec.trace.calls
