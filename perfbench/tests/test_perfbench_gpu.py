"""On the card: one short run of each cell is correct, reports its metrics
and, traced, its breakdown; a kernel's roofline share stays under 105%.
Skips where torch sees no card (decided inside the test)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "424242", "--seconds", "3",
                        "--trace", "1"], cwd=str(ROOT), capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
    for name, m in res["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
