"""The window's arithmetic and the trace's: rates over the whole window,
tails over every call, busy time as a union of intervals."""

import numpy as np
import pytest

from perfbench.harness import trace, window
from perfbench.harness.traffic import Schedule
from perfbench.harness.spec import load_module
from conftest import ROOT


class FakeClock:
    def __init__(self, durations, gap=0.0):
        self.t, self.durations, self.gap, self.i = 0.0, durations, gap, 0

    def __call__(self):
        return self.t

    def call(self, i):
        self.t += self.durations[i % len(self.durations)]


def test_closed_loop_rate_is_the_whole_window_over_the_calls():
    # nine fast calls and one slow one, over and over: the rate counts the
    # slow calls at their weight; a median of chunk medians would not
    durations = [0.001] * 9 + [0.011]
    clock = FakeClock(durations)
    window_s, lat = window.closed_loop(clock.call, 1.0, clock=clock)
    assert window_s >= 1.0 and len(lat) == pytest.approx(500, abs=10)
    assert window.per_call_ms(window_s, lat) == pytest.approx(2.0, rel=1e-2)
    assert float(np.median(lat)) * 1e3 == pytest.approx(1.0)


def test_closed_loop_ends_with_the_first_call_past_the_window():
    clock = FakeClock([0.3])
    window_s, lat = window.closed_loop(clock.call, 1.0, clock=clock)
    assert len(lat) == 4 and window_s == pytest.approx(1.2)


def test_tail_is_over_every_call():
    lat = [0.001] * 90 + [0.010] * 10
    assert window.tail_ms(lat, 95) == pytest.approx(10.0)
    # over chunk medians of 10 the tail would read less
    chunks = [np.median(lat[i:i + 10]) for i in range(0, 100, 10)]
    assert window.tail_ms(chunks, 95) < 6.0


def test_union_counts_overlapping_streams_once():
    busy = trace.union([(0, 10), (5, 15), (20, 30), (22, 25)])
    assert busy == [(0, 15), (20, 30)]
    t = trace.Trace(window=(0, 40), device=[("a", 0, 10), ("b", 5, 15),
                                            ("a", 20, 30), ("c", 22, 25)],
                    spans=[("replay", 0, 18), ("output_ready", 18, 40)],
                    calls=2)
    assert t.busy_s == pytest.approx(25e-9)
    assert t.window_s == pytest.approx(40e-9)
    assert t.kernel_s(["a"]) == pytest.approx(20e-9)
    # a sum of kernel times would read 33 ns busy
    assert sum(b - a for _, a, b in t.device) == 33
    idle = dict(t.idle_by_label())
    # a gap goes to the span the host was in at its middle
    assert idle["replay"] == pytest.approx(5e-9)         # 15..20 ns
    assert idle["output_ready"] == pytest.approx(10e-9)  # 30..40 ns
    assert t.top_ops()[0] == ["a", pytest.approx(20e-9)]


def test_trace_clips_to_the_window():
    t = trace.Trace(window=(10, 20), device=[("k", 0, 15), ("k", 18, 30)])
    assert t.busy_s == pytest.approx(7e-9)


@pytest.mark.parametrize("name", ["device.idle_pct.fixed",
                                  "device.idle_pct.moving"])
def test_idle_share_holds_traced_busy_time_against_the_untraced_window(name):
    from types import SimpleNamespace
    from conftest import ROOT
    from perfbench.harness.spec import load_module
    reader = load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", "t")
    t = trace.Trace(window=(0, 100), device=[("k", 0, 30)], calls=2)
    # 15 ns busy a call against 20 ns a call untraced: 25% idle; the traced
    # window (50 ns a call) would read 70%
    rec = SimpleNamespace(trace=t, window_s=40e-9, calls=2)
    assert reader.read(rec) == pytest.approx(25.0)
    assert reader.read(SimpleNamespace(trace=None, window_s=1.0,
                                       calls=1)) is None


@pytest.mark.parametrize("mix", ["fixed", "moving"])
def test_the_seed_fixes_every_call(mix):
    import json
    traffic = json.loads((ROOT / "perfbench" / "traffic"
                          / f"{mix}.json").read_text())
    eq = load_module(ROOT / "perfbench" / "equations" / "poisson.py", "t")
    seed = 2 ** 31 + 12345
    a, b = Schedule(traffic, eq, seed), Schedule(traffic, eq, seed)
    assert a.bank == b.bank
    assert [a.rot() for _ in range(5)] == [b.rot() for _ in range(5)]
    for i in range(100):
        a.keep(i, i)
        b.keep(i, i)
    assert a.kept == b.kept and len(a.kept) == a.samples
    c = Schedule(traffic, eq, seed + 1)
    assert c.bank != a.bank
    # every seed asks the same wave numbers
    k = sorted(np.hypot(w[0], w[1]) for w in c.bank[0]["waves"])
    assert k == pytest.approx(sorted(traffic["forcing"]["k"]))
    if mix == "moving":
        assert all(abs(a.rot()) <= traffic["turn_rad"] for _ in range(50))
