"""Whole runs of the harness on the CPU at the small sizes of ``data/``:
a correct run, the files a later change adds picked up by name, no module
of JAX or of the JAX package loaded, and the exits without a card or
without the program."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, run_cpu

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _digest(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.mark.parametrize("workload,trace", [("p.fixed", 0), ("s.moving", 1)])
def test_a_cpu_run_is_correct_and_loads_no_jax(tiny_root, workload, trace):
    rc, res, err = run_cpu(tiny_root, workload, seed=2 ** 31 + 7,
                           seconds=1.0, trace=trace)
    assert rc == 0, err[-3000:]
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec[kind]
            if workload in m.get("workloads", [workload])}
    if trace:
        # device readers find nothing on the CPU and are left out
        want = {n for n in want if not n.startswith("device.")}
        assert "breakdown" in res
    assert set(res["metrics"]) == want
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_files_a_later_change_adds_are_found_by_name(tiny_root):
    bench = tiny_root / "perfbench"
    before = _digest(bench)
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    # a new configuration, traffic mix and per-layer metric: files and
    # entries only
    cfg = json.loads((bench / "tests" / "data" / "tiny_poisson.json")
                     .read_text())
    cfg.update(name="tiny_poisson_b", M=10)
    (bench / "configs" / "tiny_poisson_b.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "fixed.json").read_text())
    mix.update(rhs_bank=3, samples=2)
    (bench / "traffic" / "fixed_small_bank.json").write_text(json.dumps(mix))
    (bench / "metrics" / "window.calls.py").write_text(
        "def read(rec):\n    return rec.calls\n")
    spec["configs"].append({"name": "tiny_poisson_b", "source": "test",
                            "file": "perfbench/configs/tiny_poisson_b.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "pb.small", "config": "tiny_poisson_b",
                              "traffic": "fixed_small_bank", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "window.calls", "unit": "calls",
                              "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "solve_ms", "workloads": ["pb.small"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("solve_ms", "solve_p95_ms"):
            m["workloads"].append("pb.small")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res, err = run_cpu(tiny_root, "pb.small", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert res["metrics"]["window.calls"]["value"] == res["attempted"]
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_no_result():
    """On this machine torch sees no card: the run exits non-zero and
    prints nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "poisson1200.fixed", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(ROOT), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: the run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "poisson1200.fixed", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    from perfbench.harness import main
    monkeypatch.setitem(sys.modules, "ipde_tpu_torch_like", object())
    assert "ipde_tpu" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ipde_tpu.config", object())
    assert "ipde_tpu" in main.forbidden_modules()
