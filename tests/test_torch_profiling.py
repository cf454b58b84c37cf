"""The port's recorder, utils/profiling.py: ``span`` and ``count`` record
nothing while recording is off, nest and add up inside ``recording()``,
record under ``torch.profiler`` on the trace's clock, and the spans of the
geometry, set-up and planify layers cover what those layers do.

The build is the planified stepper test's small problem (star(48, a=0.1,
f=3), M=8, pad_quantum 256) with a Poisson solver and its Dirichlet BIE;
a Yukawa solver and its Dirichlet BIE on the same collection record the
host-built self forms."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.solvers.bie import DirichletBIE
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.utils import profiling
from ipde_tpu_torch.utils.planify import planified, replan

NB, M, PQ = 48, 8, 256


@pytest.fixture(autouse=True)
def _drained():
    profiling.take()
    yield
    profiling.take()


def test_off_records_nothing():
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        with profiling.span("a.b"):
            profiling.count("c")
    got = profiling.take()
    assert got.spans == [] and got.counts == {}


def test_recording_nests_spans_and_adds_counts():
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("a.b"):
                profiling.count("c", 2)
            with profiling.span("a.b"):
                profiling.count("c")
        profiling.count("d")
    with profiling.span("after"):
        profiling.count("c")
    kept = profiling.take(clear=False)
    got = profiling.take()
    assert got == kept and profiling.take().spans == []
    by = {s.name: s for s in got.spans}
    assert [s.name for s in got.spans] == ["a.b", "a.b", "a"]
    assert by["a"].parent is None
    assert all(s.parent == by["a"].id for s in got.spans[:2])
    assert all(s.start_ns <= s.end_ns for s in got.spans)
    assert by["a"].start_ns <= got.spans[0].start_ns
    assert got.spans[1].end_ns <= by["a"].end_ns
    assert got.counts == {"c": 3, "d": 1}


def test_profiler_records_spans_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first record_function sets up torch's bindings (0.5-2
        # ms inside its entry, more on a loaded host); the spans compared
        # below come after it, as every span of a run after its first does
        with profiling.span("warm"):
            pass
        for _ in range(3):
            with profiling.span("outer"):
                torch.ones(64).cumsum(0)
                with profiling.span("outer.inner"):
                    torch.ones(64).sum()
                profiling.count("n")
    got = profiling.take()
    assert got.counts == {"n": 3} and len(got.spans) == 7
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ("outer", "outer.inner"):
        mine = sorted((s.start_ns, s.end_ns) for s in got.spans
                      if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 3
        for (a, b), (ea, eb) in zip(mine, theirs):
            assert abs(a - ea) <= 1_000_000 and abs(b - eb) <= 1_000_000


def _build():
    bdy = star(NB, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    c = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
        device="cpu")
    c.generate_grid(bh, pad_quantum=PQ)
    solver = PoissonSolver(c)
    return c, solver, DirichletBIE(solver)


@pytest.fixture(scope="module")
def built():
    """The build under ``recording()``: (spans, wall ns, its objects)."""
    profiling.take()
    with profiling.recording():
        t0 = time.time_ns()
        objects = _build()
        t1 = time.time_ns()
    return profiling.take().spans, t1 - t0, objects


def test_geometry_and_setup_spans_cover_the_build(built):
    spans, wall, _ = built
    names = {s.name for s in spans}
    assert {"geometry.boundary", "geometry.register", "geometry.coords",
            "geometry.masks", "geometry.plans", "setup.solver",
            "setup.annular", "setup.qfs", "setup.evaluators",
            "setup.radial_plans", "setup.bie", "setup.bie.invert"} <= names
    by = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("geometry.coords", "geometry.masks", "geometry.plans"):
            assert by[s.parent].name == "geometry.register"
        if s.name == "setup.bie.invert":
            assert by[s.parent].name == "setup.bie"
    top = [s for s in spans if s.parent is None]
    assert {s.name.split(".")[0] for s in top} == {"geometry", "setup"}
    assert sum(s.end_ns - s.start_ns for s in top) >= 0.9 * wall


def test_replan_and_gmres_reads_record_spans(built):
    c, solver, bie = built[2]
    bc = BoundaryFunction.from_function(c, lambda x, y: x * y)
    f = EmbeddedFunction.from_function(c, lambda x, y: 0.0 * x)

    def step(fg, fr):
        ue, _ = solver.solve_with_stats(EmbeddedFunction(fg, [fr]),
                                        tol=1e-10)
        return bie.apply_bc(ue, bc).grid

    call = planified(step, solver, bie)
    with profiling.recording():
        replan(call, solver, bie)
        call(f.grid, f.radials[0])
    got = profiling.take()
    names = [s.name for s in got.spans]
    assert names.count("planify.replan") == 1
    # on the CPU a planified call runs eagerly: GMRES reads, no graphs
    assert names.count("gmres.read") >= 2
    assert "planify.graphs" not in got.counts


def test_yukawa_self_forms_record_a_span_inside_qfs_or_bie(built):
    spans, _, (c, _, _) = built
    assert "setup.self_forms" not in {s.name for s in spans}
    with profiling.recording():
        DirichletBIE(ModifiedHelmholtzSolver(c, k=2.0))
    got = profiling.take().spans
    by = {s.id: s for s in got}
    forms = [s for s in got if s.name == "setup.self_forms"]
    # the QFS maps' SLP and DLP self forms, and the BIE's DLP self block
    assert len(forms) >= 3
    assert {by[s.parent].name for s in forms} == {"setup.qfs", "setup.bie"}
