"""The 95th percentile of every solve's latency in the window, in ms: from
handing in its inputs to its output being ready."""

from perfbench.harness.window import tail_ms


def read(rec):
    return tail_ms(rec.latencies, 95.0) if rec.latencies else None
