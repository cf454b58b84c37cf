"""The window over the moving-boundary steps completed in it, in ms: each
step moves the boundary, rebuilds the problem, replans and solves."""

from perfbench.harness.window import per_call_ms


def read(rec):
    return per_call_ms(rec.window_s, rec.latencies) if rec.latencies \
        else None
