"""The control of the output check: the plain reference put in the
program's place, computed one precision below the configuration's
(float32 for float64), and held to the same limits.

    python3 perfbench/control.py [--cells c1 c2 ...] [--seeds 1 2 3]

For each cell and seed it draws the calls the run would draw (right-hand
sides and, for a moving mix, angles), evaluates each solution in float32 at
the reference's points of the cell's own size, and prints each check's
number beside the cell's limit.  The control has to fail the check; the
benchmark's own runs do not run it.  NumPy only: it needs no card."""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import spec  # noqa: E402
from perfbench.harness.traffic import Schedule  # noqa: E402
from perfbench.reference.compare import errors  # noqa: E402
from perfbench.reference.geometry import Geometry  # noqa: E402


def control_errors(cell, seed, calls=None):
    """{check: largest error} of the float32 control over the first
    ``calls`` (default: the mix's ``samples``) calls of a run with
    ``seed``."""
    eq = cell.equation
    sched = Schedule(cell.traffic, eq, seed)
    n = calls or sched.samples
    worst = {name: 0.0 for name in eq.CHECKS}
    geos = {}
    for i in range(n):
        rot = sched.rot()
        geo = geos.get(rot) or geos.setdefault(rot, Geometry(cell.cfg, rot))
        p = sched.bank[sched.rhs(i)]
        grid = eq.exact(p, geo.X, geo.Y, np.float32)
        rad = eq.exact(p, geo.rx, geo.ry, np.float32)
        fields = {f: (grid[f], rad[f]) for f in eq.FIELDS}
        for k, v in errors(eq, p, fields, geo).items():
            worst[k] = max(worst[k], v)
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cells", nargs="*")
    p.add_argument("--seeds", nargs="*", type=int, default=[1, 2, 3])
    a = p.parse_args(argv)
    names = a.cells or [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    for name in names:
        cell = spec.resolve(ROOT, name)
        for seed in a.seeds:
            worst = control_errors(cell, seed)
            print(json.dumps({"cell": name, "seed": seed, "control": worst,
                              "limits": cell.cfg["limits"]}), flush=True)


if __name__ == "__main__":
    main()
