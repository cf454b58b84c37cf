"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric: a
cell's configuration is the file its ``configs`` entry gives, its traffic
mix is ``traffic/<traffic>.json``, each metric is read by
``metrics/<name>.py``, and each equation by ``equations/<equation>.py``, all
beside ``run.py``.  A later cell, mix, metric or equation is a new file and
a new entry, and no existing file changes."""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, prefix: str):
    """Import the file ``path`` under a private module name."""
    name = f"perfbench_{prefix}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    equation: object
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    def reader(self, metric: dict):
        return load_module(self.bench_dir / "metrics" / f"{metric['name']}.py",
                           "metric")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files;
    KeyError for a name the benchmark does not hold."""
    root, bench_dir = Path(root), Path(bench_dir)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    equation = load_module(bench_dir / "equations" / f"{cfg['equation']}.py",
                           "equation")
    return Cell(
        name=workload, chips=int(w["chips"]), cfg=cfg, traffic=traffic,
        equation=equation,
        end_to_end=[m for m in spec["end_to_end"] if _listed(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _listed(m, workload)],
        bench_dir=bench_dir)
