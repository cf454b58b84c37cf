"""ms per moving-boundary step in the benchmark's span around moving the boundary and registering it on the set-up grid (``geometry/*``, ``native/coords.cpp``), ended by synchronize."""


def read(rec):
    v = rec.spans.get("geometry")
    return 1e3 * sum(v) / len(v) if v else None
