"""Replan shape misses per moving-boundary step: ``replan`` raised on a plan
tensor of another shape, and the step captured the solve again."""


def read(rec):
    if "replan" not in rec.spans:
        return None
    return rec.counters["replan_misses"] / rec.calls
