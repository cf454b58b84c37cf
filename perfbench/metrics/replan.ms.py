"""ms per moving-boundary step in the benchmark's span around ``replan`` of the captured solve onto the rebuilt objects, and on a plan shape miss the new capture and its first replay, ended by synchronize."""


def read(rec):
    v = rec.spans.get("replan")
    return 1e3 * sum(v) / len(v) if v else None
