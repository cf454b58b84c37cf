"""BENCHMARK.json against the benchmark's contract, and every file it
names."""

import json
import math
import re

import pytest
from conftest import ROOT

from perfbench.harness import spec as specmod

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells, 14 runs each, fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        eq = specmod.load_module(
            ROOT / "perfbench" / "equations" / f"{cfg['equation']}.py", "t")
        assert set(cfg["limits"]) == set(eq.CHECKS)


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(0.25 * len(SPEC["workloads"])))


def _metric_keys(m, e2e):
    base = {"name", "unit", "better", "source"}
    base |= {"bound"} if e2e else {"layer", "moves"}
    assert set(m) - {"workloads"} == base
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in (SOURCES_E2E if e2e else SOURCES)
    for w in m.get("workloads", []):
        assert w in CELLS
    assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_end_to_end():
    e2e = SPEC["end_to_end"]
    assert 1 <= len(e2e) <= 16
    names = [m["name"] for m in e2e]
    assert "setup_s" in names
    for m in e2e:
        _metric_keys(m, True)
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer():
    per = SPEC["per_layer"]
    assert 1 <= len(per) <= 128
    for m in per:
        _metric_keys(m, False)
        assert line_ok(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_names_a_metric_all_of_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, cell) for m in SPEC["per_layer"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    c = specmod.resolve(ROOT, cell)
    assert c.name == cell and c.chips == 1
    for m in c.end_to_end + c.per_layer:
        assert hasattr(c.reader(m), "read")
