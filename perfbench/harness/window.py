"""The measured window: a closed loop of one caller, and what a window's
calls add up to.

``closed_loop(call, seconds)`` makes calls back to back from the moment it
starts until a call ends at or after ``seconds``: each call's latency runs
from handing in its inputs to its output being ready (the call itself
synchronizes).  The window is the time from the first call's start to the
last call's end, so a rate is the whole window over every call completed
in it, and a tail is taken over every call's latency."""

import time

import numpy as np


def closed_loop(call, seconds, clock=time.perf_counter):
    """(window seconds, [latency seconds per call]); ``call(i)``."""
    lat = []
    t0 = clock()
    i = 0
    while True:
        ts = clock()
        call(i)
        te = clock()
        lat.append(te - ts)
        i += 1
        if te - t0 >= seconds:
            return te - t0, lat


def per_call_ms(window_s, latencies):
    """The window over the calls completed in it, in ms."""
    return 1e3 * window_s / len(latencies)


def tail_ms(latencies, q=95.0):
    """The q-th percentile of every call's latency, in ms (linear between
    order statistics)."""
    return 1e3 * float(np.percentile(np.asarray(latencies), q))
