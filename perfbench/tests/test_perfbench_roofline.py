"""The roofline's work and bound at both configurations' fft shapes agree
with the kernel table of PERF.md (section 6, "The fft path's launches")."""

import json

import pytest
from conftest import ROOT

from perfbench.harness import roofline

# PERF.md section 6: the five launches of one fft solve, T x S, and the
# bound of each in ms
PERF_MD = {
    "poisson_star1200_M16": ("laplace_slp", [
        ((1200, 3600), 0.0011), ((7200, 3600), 0.0069),
        ((12000, 1800), 0.0057), ((8400, 3600), 0.0080),
        ((10800, 1800), 0.0051)]),
    "stokes_star1200_M16_tier1": ("stokes_slp", [
        ((1200, 3600), 0.0028), ((13200, 3600), 0.0307),
        ((6000, 1800), 0.0070), ((15600, 3600), 0.0363),
        ((3600, 1800), 0.0042)]),
}


@pytest.mark.parametrize("name", sorted(PERF_MD))
def test_pairs_and_bounds_match_perf_md(name):
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{name}.json").read_text())
    kernel, launches = PERF_MD[name]
    assert cfg["kernel"] == kernel
    assert [tuple(p) for p in cfg["slp_pairs_per_solve"]] == \
        [s for s, _ in launches]
    for (T, S), ms in launches:
        got, what = roofline.bound_s(kernel, T, S)
        assert got * 1e3 == pytest.approx(ms, abs=6e-5)
        assert what == "operations"
    # the radial groups cover every radial node twice (the solve's
    # correction and the BIE's), the interface once
    n, m = cfg["boundary"]["N"], cfg["M"]
    T = [t for t, _ in cfg["slp_pairs_per_solve"]]
    assert T[0] == n and sum(T[1:]) == 2 * m * n


def test_solve_bounds():
    assert roofline.solve_bound_s("laplace_slp", [s for s, _ in PERF_MD[
        "poisson_star1200_M16"][1]]) * 1e3 == pytest.approx(0.0268,
                                                             abs=1e-4)
    assert roofline.solve_bound_s("stokes_slp", [s for s, _ in PERF_MD[
        "stokes_star1200_M16_tier1"][1]]) * 1e3 == pytest.approx(0.0810,
                                                                 abs=1e-4)
