"""The port's stratified radial plans (ipde_tpu_torch.ops.stratified)
against ipde_tpu's: the distance search that sets a plan's strides runs as
torch ops on the plan's device, and the strides, the pair fraction, every
row group's five tensors and the row order are ipde_tpu's bit for bit.
Both plans are built from the same host inputs: the port's geometry of the
benchmark's boundaries (``perfbench/configs/*.json``), as set up and turned
by +-0.05 rad, a circle (ties in the coarse search) and a problem whose
search takes two row chunks.  Marker ``gpu``: the card's plans against a
CPU build of the same inputs, and a ``laplace_slp`` radial apply through
both on the card."""

import copy
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_testing import cuda_or_skip
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu.ops.stratified import StratifiedRadialApply as JSRA
from ipde_tpu_torch.geometry import curve as curves
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels
from ipde_tpu_torch.ops import stratified
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.utils import profiling

CONFIGS = Path(__file__).resolve().parents[1] / "perfbench" / "configs"
POISSON, STOKES = "poisson_star1200_M16", "stokes_star1200_M16_tier1"


@functools.lru_cache(maxsize=None)
def config_boundary(name, rot=0.0):
    """The port's EmbeddedBoundary of configuration ``name``, turned by
    ``rot``, with the grid spacing of the benchmark's set-up geometry
    (``perfbench/harness/problem.py::Geometry``)."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    b, M, s = cfg["boundary"], cfg["M"], cfg["sizing"]
    kw = {k: b[k] for k in ("x", "y", "r", "a", "f")}
    base = getattr(curves, b["curve"])(b["N"], **kw)
    h = min(base.min_h(),
            s["curvature_factor"] / np.abs(base.curvature).max() / M)
    if s.get("grid_target"):
        h = min(h, float(base.x.max() - base.x.min())
                / (s["grid_target"] - 3 * M))
    bdy = getattr(curves, b["curve"])(b["N"], rot=rot, **kw)
    return EmbeddedBoundary(bdy, True, M, h,
                            qfs_tolerance=cfg["qfs_tolerance"])


def sources(e):
    """The sources of a one-boundary problem's two radial plans: the
    solver's correction (``_ScalarHelper.radial_source``) and the BIE's
    own rows."""
    return {"solver": e.qfs_source_for_side("interface",
                                            interior_eval=not e.interior),
            "bie": e.qfs_source_for_side("bdy", interior_eval=e.interior)}


def search_pairs(src, M, n):
    """The pairs a plan's distance search takes: T targets against the
    coarse sources and the refine window."""
    cs = max(1, src.N // 256)
    return M * n * (len(src.x[::cs]) + 2 * cs + 1)


def bits(a):
    """An array's bits: float64 as uint64, integers as they are."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint64) if a.dtype == np.float64 else a.astype(np.int64)


def assert_plans_equal(got, want):
    """Port plan ``got`` against ipde_tpu's ``want``."""
    assert np.array_equal(got.strides, want.strides)
    assert got.pair_fraction == want.pair_fraction
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        assert g[0] == w[0]
        # want: (f, rows, tx, ty, sx, sy, sw), got: (f, tx, ty, sx, sy, sw)
        for a, b in zip(g[1:], w[2:]):
            assert a.dtype == torch.float64 and a.is_contiguous()
            assert np.array_equal(bits(a), bits(b))
    assert np.array_equal(bits(got._inv_rows), bits(want._inv_rows))


def build(src, radial_x, radial_y, device="cpu", **kw):
    """(port plan on ``device``, the ``stratified.search_pairs`` its build
    counted)."""
    profiling.take()
    with profiling.recording():
        plan = StratifiedRadialApply(src, radial_x, radial_y,
                                     device=device, **kw)
    return plan, profiling.take().counts.get("stratified.search_pairs", 0)


@pytest.mark.parametrize("which", ["solver", "bie"])
@pytest.mark.parametrize("rot", [0.0, 0.05, -0.05])
def test_star_plan_matches_ipde_tpu(rot, which):
    e = config_boundary(POISSON, rot)
    src = sources(e)[which]
    kw = dict(k_density=e.bdy.N // 2)
    got, pairs = build(src, e.radial_x, e.radial_y, **kw)
    assert_plans_equal(got, JSRA(src, e.radial_x, e.radial_y, **kw))
    M, n = e.radial_x.shape
    assert pairs == search_pairs(src, M, n) == 5_510_400
    assert set(got.strides.tolist()) == {1, 2}


def test_max_stride_one_takes_no_search():
    e = config_boundary(POISSON)
    src = sources(e)["bie"]
    kw = dict(k_density=e.bdy.N // 2, max_stride=1)
    got, pairs = build(src, e.radial_x, e.radial_y, **kw)
    assert_plans_equal(got, JSRA(src, e.radial_x, e.radial_y, **kw))
    assert pairs == 0
    assert got.strides.tolist() == [1] * e.M and got.pair_fraction == 1.0


def test_circle_ties():
    bdy = curves.circle(400)
    M = 12
    h = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    e = EmbeddedBoundary(bdy, True, M, h)
    for src in sources(e).values():
        # the coarse search's minimum ties between two sources for some
        # targets: argmin has to take the first, as NumPy's does
        cs = max(1, src.N // 256)
        tx, ty = e.radial_x.reshape(-1, 1), e.radial_y.reshape(-1, 1)
        dx, dy = tx - src.x[::cs], ty - src.y[::cs]
        q = dx * dx + dy * dy
        assert ((q == q.min(1, keepdims=True)).sum(1) > 1).any()
        kw = dict(k_density=e.bdy.N // 2)
        got, pairs = build(src, e.radial_x, e.radial_y, **kw)
        assert_plans_equal(got, JSRA(src, e.radial_x, e.radial_y, **kw))
        assert pairs == search_pairs(src, *e.radial_x.shape)


def test_two_row_chunks():
    # 16 rows of 2,200 targets inside a 6,600-point source star: 264
    # coarse sources, 9,292,800 coarse pairs, two row chunks
    M, nb = 16, 2200
    src = curves.star(3 * nb, a=0.2, f=3)
    inner = curves.star(nb, a=0.2, f=3)
    scale = 1.0 - 0.01 * np.arange(1, M + 1)[:, None]
    radial_x, radial_y = scale * inner.x, scale * inner.y
    cs = src.N // 256
    coarse = M * nb * len(src.x[::cs])
    rows = stratified.SEARCH_PAIRS_PER_CHUNK // (nb * len(src.x[::cs]))
    assert coarse > stratified.SEARCH_PAIRS_PER_CHUNK
    assert -(-M // rows) == 2
    kw = dict(k_density=nb // 2)
    got, pairs = build(src, radial_x, radial_y, **kw)
    assert_plans_equal(got, JSRA(src, radial_x, radial_y, **kw))
    assert pairs == search_pairs(src, M, nb)
    assert len(got.groups) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [0.0, 0.05, -0.05])
@pytest.mark.parametrize("name", [POISSON, STOKES])
def test_card_plan_matches_cpu_build(name, rot):
    dev = cuda_or_skip()
    e = config_boundary(name, rot)
    rng = np.random.default_rng(22)
    for src in sources(e).values():
        kw = dict(k_density=e.bdy.N // 2)
        card, pairs = build(src, e.radial_x, e.radial_y, device=dev, **kw)
        host, _ = build(src, e.radial_x, e.radial_y, **kw)
        assert pairs == search_pairs(src, *e.radial_x.shape)
        assert all(t.device == dev for g in card.groups for t in g[1:])
        assert card._inv_rows.device == dev
        assert np.array_equal(card.strides, host.strides)
        assert card.pair_fraction == host.pair_fraction
        for g, w in zip(card.groups, host.groups, strict=True):
            assert g[0] == w[0]
            for a, b in zip(g[1:], w[1:]):
                assert np.array_equal(bits(a), bits(b))
        assert np.array_equal(bits(card._inv_rows), bits(host._inv_rows))
        # the CPU build's tensors on the card: the same kernel launches
        moved = copy.copy(host)
        moved.groups = [(g[0], *(t.to(dev) for t in g[1:]))
                        for g in host.groups]
        moved._inv_rows = host._inv_rows.to(dev)
        sig = torch.as_tensor(rng.standard_normal(src.N), device=dev)

        def slp(sx, sy, ws, f, tx, ty):
            return kernels.laplace_slp_apply(sx, sy, sig[::f] * ws, tx, ty)

        got, want = card.apply(slp), moved.apply(slp)
        assert got.device == dev
        assert np.array_equal(bits(got), bits(want))
