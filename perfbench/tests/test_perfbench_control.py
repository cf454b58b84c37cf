"""The control: the plain reference in the program's place, one precision
below the configuration's (float32 for float64), at each cell's own size
on three seeds, fails the cell's check."""

import json

import pytest
from conftest import ROOT

from perfbench.control import control_errors
from perfbench.harness import spec

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    c = spec.resolve(ROOT, cell)
    assert c.cfg["precision"] == "float64"
    for seed in (1, 2, 2 ** 31 + 3):
        worst = control_errors(c, seed, calls=2)
        assert any(v > c.cfg["limits"][k] for k, v in worst.items()), worst
