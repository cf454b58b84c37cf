"""The port's example scripts (examples/torch_*.py), its ledger, timer and
entry point, on the CPU: each refinement script's run_case at its smallest
default row on device="cpu", held to that row's rule and, within 1%, to
ipde_tpu's error on the same row computed here (the reference script's own
run_case; for the three-body Stokes row tools/ipde_tpu_three_body_stokes.py
with the port's BIE radial plans, since ipde_tpu's own plans differ, on
ipde_tpu's dense grid backend);
``record`` into a ledger under pytest's tmp_path only (the repo's
LEDGER_TPU.json and LEDGER_TORCH.json are never touched); ``Timer``;
``entry()`` against the analytic solution.  The warm solves of the scripts
are cut to one here (their timings are not what is tested)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (see tests/test_torch_multi_body.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _load(rel):
    """A script of the repo (path relative to its root) as a module."""
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name):
    return _load(os.path.join("examples", name + ".py"))


@pytest.fixture(autouse=True)
def _one_warm_solve(monkeypatch):
    import _torch_common
    monkeypatch.setattr(_torch_common, "WARM_SOLVES", 1)


def _row_ok(row):
    assert row["residual"] <= row["tol"]
    assert row["first_s"] > 0 and row["solve_ms_min"] <= row["solve_ms"] \
        <= row["solve_ms_max"]


def test_poisson_refinement_smallest_row():
    ex = _example("torch_poisson_refinement")
    row = ex.run_case(200, 8, device="cpu")
    _row_ok(row)
    assert row["tol"] == 1e-13 and row["grid"] == [128, 128]
    assert ex.check(row) and row["ref_err"] == 5.5635e-04
    ref = _example("poisson_refinement").run_case(200, 8)["err"]
    assert abs(row["err"] / ref - 1.0) <= 0.01


def test_mh_neumann_refinement_smallest_row():
    ex = _example("torch_mh_neumann_refinement")
    row = ex.run_case(1.0, 200, 10, device="cpu")
    _row_ok(row)
    assert row["k2"] == 1.0 and row["tol"] == 1e-13
    ref = _example("mh_neumann_refinement").run_case(1.0, 200, 10)["err"]
    assert abs(row["err"] / ref - 1.0) <= 0.01


def test_stokes_refinement_smallest_row():
    ex = _example("torch_stokes_refinement")
    row = ex.run_case(100, 8, device="cpu")
    _row_ok(row)
    assert row["tol"] == 1e-12 and len(row["iterations"]) == 3
    assert ex.check(row) and row["ref_err"] == 2.5864e-01
    # ipde_tpu's dense grid backend: the same error as its fft one on this
    # row (1.3272890538151838e-05 both), at a quarter of the CPU time
    ref = _load("tools/ipde_tpu_three_body_stokes.py").run(
        100, 8, "dense", "port")["err"]
    assert abs(row["err"] / ref - 1.0) <= 0.01


def test_record_merges_rows(tmp_path):
    from ipde_tpu_torch.utils.ledger import record
    path = str(tmp_path / "LEDGER_TORCH.json")
    record("study", [{"nb": 200, "err": 1.0}, {"nb": 600, "err": 2.0}],
           ("nb",), path=path, device="cpu")
    block = record("study", [{"nb": 200, "err": 0.5}], ("nb",), path=path,
                   device="cpu")
    assert [(r["nb"], r["err"]) for r in block["rows"]] == [(200, 0.5),
                                                            (600, 2.0)]
    assert all(r["device"] == "cpu" and r["power_limit"] is None
               for r in block["rows"])
    with open(path) as fh:
        assert list(json.load(fh)) == ["study@cpu"]


def test_timer_and_sync(tmp_path):
    from ipde_tpu_torch.utils.profiling import Timer, time_solves, trace
    timer = Timer()
    for _ in range(2):
        out = []
        with timer("phase", out):
            out.append(torch.ones(3).sum())
    assert timer.counts == {"phase": 2} and timer.totals["phase"] > 0
    assert timer.report().startswith("phase: ")
    res, t = time_solves(lambda: torch.arange(4.0), warm=3)
    assert res.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert t["solve_ms_min"] <= t["solve_ms"] <= t["solve_ms_max"]
    path = tmp_path / "trace.json"
    with trace(str(path)):
        torch.ones(8).cumsum(0)
    assert "traceEvents" in json.loads(path.read_text())


def test_entry_on_cpu():
    from ipde_tpu_torch.entry import entry, sol
    fn, args = entry(device="cpu")
    u = fn(*args)
    ebdyc = fn.solver.ebdyc
    g = ebdyc.grid
    assert u.shape == g.shape and u.device.type == "cpu"
    # 1.17e-6 at nb=128, M=8: the problem's resolution (the port's solve
    # of this problem equals ipde_tpu's, tests/test_torch_solvers.py)
    err = np.abs(u.numpy() - sol(g.xg, g.yg))[ebdyc.phys].max()
    assert err < 2e-6
