"""Shared pieces of the benchmark's own tests (CPU, and ``gpu``-marked on
the card)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


TINY = {"poisson": ("tiny_poisson", "p"), "stokes": ("tiny_stokes", "s")}


def tiny_benchmark():
    """BENCHMARK.json with each cell swapped for a small CPU cell of the
    same equation and traffic mix (``p.fixed``, ``s.moving``, ...), on the
    configurations of ``data/``; every metric is kept, listing the small
    cells of the cells it lists.  A cell of an equation with no small
    configuration has no small cell."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in spec["configs"]}
    small = {}
    for w in spec["workloads"]:
        eq = json.loads((ROOT / files[w["config"]]).read_text())["equation"]
        if eq in TINY:
            small[w["name"]] = (TINY[eq], w["traffic"])
    spec["configs"] = [
        {"name": name, "source": "test", "reduced": [], "why": "test",
         "file": f"perfbench/tests/data/{name}.json"}
        for name in sorted({cfg for (cfg, _), _ in small.values()})]
    spec["workloads"] = [
        {"name": f"{tag}.{traffic}", "config": cfg, "traffic": traffic,
         "chips": 1, "why": "test"}
        for (cfg, tag), traffic in dict.fromkeys(small.values())]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(dict.fromkeys(
                f"{small[w][0][1]}.{small[w][1]}"
                for w in m["workloads"] if w in small))
    return spec


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root whose BENCHMARK.json is ``tiny_benchmark()`` over a
    copy of the benchmark's folder."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(tiny_benchmark()))
    return tmp_path


def run_cpu(root, workload, seed=5, seconds=1.0, trace=0, bench_dir=None):
    """Run ``main`` on the CPU in a fresh process: (rc, result or None,
    stderr)."""
    bench_dir = bench_dir or Path(root) / "perfbench"
    code = ("import sys; sys.path.insert(0, %r); "
            "from perfbench.harness.main import main; "
            "sys.exit(main(%r, allow_cpu=True, root=%r, bench_dir=%r))"
            % (str(ROOT), ["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
               str(root), str(bench_dir)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    lines = p.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return p.returncode, result, p.stderr
