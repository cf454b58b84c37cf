"""The output check catches a broken timed path.  Each test drives a whole
CPU run with the program broken underneath it (the harness's look for a
card skipped) and sees ``correct`` come out false: a step that returns its
state unchanged, and an answer altered where it is produced.  The cells
have no batch to halve and no exchange between chips to drop (one solve
per call, one card)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

FAULTS = {
    # the planified call answers every call with its first output
    "stale_output": """
import perfbench.harness.problem as problem
_plan = problem.plan
def plan(fn, *roots):
    call = _plan(fn, *roots)
    first = []
    def stale(*a):
        out = call(*a)
        if not first:
            first.append(out)
        return first[0]
    return stale
problem.plan = plan
""",
    # replan leaves the captured solve on the set-up geometry
    "stale_replan": """
import perfbench.harness.problem as problem
problem.replan = lambda call, *roots: call
""",
    # one grid value of the first output field altered where it is made
    "altered_answer": """
import perfbench.harness.main as hm
_step = hm.plan_step
def plan_step(*a, **k):
    fn = _step(*a, **k)
    def broken(*args):
        out, st = fn(*args)
        g = out[0].clone()
        g[g.shape[0] // 2, g.shape[1] // 2] += 1e-3
        return [g] + list(out[1:]), st
    return broken
hm.plan_step = plan_step
""",
}

CASES = [("p.fixed", "stale_output"), ("p.fixed", "altered_answer"),
         ("s.fixed", "altered_answer"), ("p.moving", "stale_replan"),
         ("p.moving", "altered_answer")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            + FAULTS[fault]
            + "from perfbench.harness.main import main\n"
            f"sys.exit(main(['--workload', {workload!r}, '--seed', '11', "
            f"'--seconds', '3', '--trace', '0'], allow_cpu=True, "
            f"root={str(tiny_root)!r}, "
            f"bench_dir={str(tiny_root / 'perfbench')!r}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    # a stale answer is the right one for the window's first call alone
    assert res["attempted"] >= 2
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
