"""The readers of the program's own spans and counters
(``metrics/_program_spans.py``): each reads a number on its small CPU
cells traced, a part leaves out the parts nested in it, the set-up's busy
share reads the trace's device intervals, and a program that records
nothing (no ``profiling.take``) gives None."""

import json
from types import SimpleNamespace

import pytest
from conftest import ROOT, run_cpu

from ipde_tpu_torch.utils import profiling
from perfbench.harness.spec import load_module
from perfbench.harness.trace import Trace

NEW = {"geometry.coords.ms", "geometry.masks.ms", "geometry.plans.ms",
       "setup.annular.ms", "setup.qfs.ms", "setup.evaluators.ms",
       "setup.radial_plans.ms", "setup.bie.ms", "setup.device_busy_pct",
       "replan.capture.ms", "replay.graphs", "replay.read_wait.ms"}
shared = load_module(ROOT / "perfbench" / "metrics" / "_program_spans.py",
                     "test")


def _listed(tiny_root, workload):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    return {m["name"] for m in spec["per_layer"]
            if m["name"] in NEW and workload in m["workloads"]}


@pytest.mark.parametrize("workload", ["p.moving", "p.fixed"])
def test_each_new_reader_reads_its_traced_cells(tiny_root, workload):
    rc, res, err = run_cpu(tiny_root, workload, seed=2 ** 31 + 17,
                           seconds=1.0, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    want = _listed(tiny_root, workload)
    assert want == (NEW - {"replay.graphs", "replay.read_wait.ms"}
                    if workload.endswith("moving")
                    else {"replay.graphs", "replay.read_wait.ms"})
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    assert set(got) == want
    if workload.endswith("moving"):
        for k in ("geometry.coords.ms", "geometry.masks.ms",
                  "geometry.plans.ms", "setup.qfs.ms",
                  "setup.evaluators.ms", "setup.radial_plans.ms",
                  "setup.bie.ms"):
            assert got[k] > 0.0, k
        # no device on the CPU: busy none of the set-up; no capture there
        assert got["setup.device_busy_pct"] == 0.0
        assert got["replan.capture.ms"] == 0.0
    else:
        # a planified call on the CPU runs eagerly: reads, no graphs
        assert got["replay.graphs"] == 0.0
        assert got["replay.read_wait.ms"] > 0.0


def _span(name, i, parent, a, b):
    return profiling.Span(name, i, parent, a, b)


def _rec(device=()):
    return SimpleNamespace(trace=Trace((0, 1000), list(device), calls=2))


SPANS = [_span("setup.qfs", 3, 2, 10, 30),
         _span("setup.evaluators", 4, 2, 35, 45),
         _span("setup.bie.invert", 5, 2, 50, 60),
         _span("setup.bie", 2, 1, 5, 100),
         _span("setup.solver", 1, None, 0, 200),
         _span("gmres.read", 6, None, 300, 340),
         _span("setup.qfs", 7, None, 2000, 3000)]       # outside the window


def test_a_part_leaves_out_the_parts_nested_in_it(monkeypatch):
    monkeypatch.setattr(profiling, "take", lambda clear=True:
                        profiling.Recorded(SPANS, {"planify.graphs": 14}))
    rec = _rec(device=[("k", 0, 20), ("k", 90, 150)])
    ns = lambda part: shared.part_ms(rec, part) * 2e6   # noqa: E731
    assert ns("setup.bie") == pytest.approx(95 - 20 - 10)   # with invert
    assert ns("setup.qfs") == pytest.approx(20)
    assert ns("setup.evaluators") == pytest.approx(10)
    assert ns("planify.capture") == 0
    assert shared.span_ms(rec, "gmres.read") * 2e6 == pytest.approx(40)
    assert shared.per_call(rec, "planify.graphs") == 7
    # setup spans cover [0, 200]; the device is busy in [0, 20], [90, 150]
    assert shared.busy_pct(rec, "setup") == pytest.approx(100 * 80 / 200)
    assert shared.busy_pct(_rec(), "setup") == 0.0


def test_nothing_to_read_gives_none(monkeypatch):
    assert shared.part_ms(SimpleNamespace(trace=None), "setup.qfs") is None
    monkeypatch.delattr(profiling, "take")
    rec = _rec()
    assert shared.part_ms(rec, "setup.qfs") is None
    assert shared.busy_pct(rec, "setup") is None
    assert shared.per_call(rec, "planify.graphs") is None
