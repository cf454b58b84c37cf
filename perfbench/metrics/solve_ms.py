"""The window over the solves completed in it, in ms."""

from perfbench.harness.window import per_call_ms


def read(rec):
    return per_call_ms(rec.window_s, rec.latencies) if rec.latencies \
        else None
