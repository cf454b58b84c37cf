"""The Yukawa configuration on the benchmark: a small copy of
``mh_star800_M20_k2`` (``data/tiny_mh.json``) run whole on the CPU is
correct and loads no JAX; ``mh_slp_roofline``'s bound and reader; a forcing
without kappa in the program's input reads ``correct`` false."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
from conftest import ROOT, run_cpu

from perfbench.harness.spec import load_module
from perfbench.harness.trace import Trace

CELL = "mh_k2.fixed"
SMALL = "m.fixed"
READER = load_module(ROOT / "perfbench" / "metrics" / "mh_slp_roofline.py",
                     "metric")


@pytest.fixture
def mh_root(tiny_root):
    """``tiny_root`` with a small cell of the Yukawa configuration, listed
    wherever the benchmark lists ``mh_k2.fixed``."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_mh", "source": "test",
                            "reduced": [], "why": "test",
                            "file": "perfbench/tests/data/tiny_mh.json"})
    spec["workloads"].append({"name": SMALL, "config": "tiny_mh",
                              "traffic": "fixed", "chips": 1,
                              "why": "test"})
    listed = {m["name"] for m in real["end_to_end"] + real["per_layer"]
              if CELL in m.get("workloads", [])}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append(SMALL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def test_the_small_yukawa_cell_is_correct_and_loads_no_jax(mh_root):
    rc, res, err = run_cpu(mh_root, SMALL, seed=2 ** 31 + 11, seconds=1.0,
                           trace=1)
    # main() exits 3 with no result where a module of JAX is loaded
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert res["checks"]["u_err"]["value"] <= \
        res["checks"]["u_err"]["limit"]
    # the device readers, the roofline among them, find nothing on the CPU
    assert {"gmres.iters", "replay.host_reads"} <= set(res["metrics"])
    assert "mh_slp_roofline" not in res["metrics"]


def test_the_bound_of_a_solve():
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "mh_star800_M20_k2.json").read_text())
    pairs = cfg["slp_pairs_per_solve"]
    assert [tuple(p) for p in pairs] == [
        (800, 2400), (8000, 2400), (8000, 1200), (8000, 2400), (8000, 1200)]
    assert sum(t * s for t, s in pairs) == 59_520_000
    assert all(READER.bound_s(t, s)[1] == "operations" for t, s in pairs)
    # 59,520,000 pairs x 82 operations / 34 TFLOP/s
    assert READER.solve_bound_s(pairs) * 1e3 == pytest.approx(0.1436,
                                                              abs=1e-4)


def _rec(kernel, device):
    cfg = {"kernel": kernel, "slp_pairs_per_solve": [[800, 2400]]}
    return SimpleNamespace(cfg=cfg, trace=Trace(window=(0, 10 ** 9),
                                                device=device, calls=2))


def test_the_reader_reads_only_its_kernel():
    # 2 calls, 0.2 ms of the kernel and its split combine in each
    ops = [("mh_slp_kernel(double const*)", 0, 300_000),
           ("void fp64::combine_splits_kernel<1>(double const*)", 300_000,
            400_000), ("regular_fft_r2c<800u>", 400_000, 900_000)]
    got = READER.read(_rec("mh_slp", ops))
    want = 100.0 * READER.solve_bound_s([[800, 2400]]) / 2e-4
    assert got == pytest.approx(want, rel=1e-12)
    assert READER.read(_rec("laplace_slp", ops)) is None
    assert READER.read(_rec("mh_slp", ops[2:])) is None
    assert READER.read(SimpleNamespace(cfg={"kernel": "mh_slp"},
                                       trace=None)) is None


# the program is handed the forcing of -lap u = f (kappa = 0) with the
# boundary data of u; the reference holds the output to u
KAPPA_ZERO = """
import perfbench.harness.problem as problem
_inputs = problem.inputs
def inputs(eq, params, geo):
    kept, eq.KAPPA = eq.KAPPA, 0.0
    try:
        return _inputs(eq, params, geo)
    finally:
        eq.KAPPA = kept
problem.inputs = inputs
"""


def test_a_forcing_without_kappa_is_not_correct(mh_root):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            + KAPPA_ZERO
            + "from perfbench.harness.main import main\n"
            f"sys.exit(main(['--workload', {SMALL!r}, '--seed', '13', "
            f"'--seconds', '1', '--trace', '0'], allow_cpu=True, "
            f"root={str(mh_root)!r}, "
            f"bench_dir={str(mh_root / 'perfbench')!r}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["u_err"]["value"] > res["checks"]["u_err"]["limit"]
