"""The plain reference's geometry, worked out from the configuration alone,
is the program's: the same box, the same physical points, the same radial
nodes, at the small CPU sizes and at both cells' own sizes (geometry
only), the set-up boundary and a turned one."""

import json

import numpy as np
import pytest
import torch
from conftest import DATA, ROOT

from perfbench.harness import problem
from perfbench.reference import geometry as ref

CONFIGS = [DATA / "tiny_poisson.json", DATA / "tiny_stokes.json",
           ROOT / "perfbench" / "configs" / "poisson_star1200_M16.json",
           ROOT / "perfbench" / "configs" / "stokes_star1200_M16_tier1.json"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_reference_geometry_is_the_programs(path):
    cfg = json.loads(path.read_text())
    base = problem.Geometry(cfg, torch.device("cpu"))
    for rot in (0.0, 0.0371):
        geo = base if rot == 0.0 else problem.Geometry(
            cfg, torch.device("cpu"), rot, base=base)
        r = ref.Geometry(cfg, rot)
        assert r.h == pytest.approx(geo.h, rel=1e-13)
        g = geo.grid
        assert r.X.shape == g.shape
        assert np.abs(r.X - g.xg).max() < 1e-13
        assert np.abs(r.Y - g.yg).max() < 1e-13
        assert np.array_equal(r.phys, geo.ebdyc.phys)
        e = geo.ebdyc.ebdys[0]
        assert np.abs(r.rx - e.radial_x).max() < 1e-13
        assert np.abs(r.ry - e.radial_y).max() < 1e-13


def test_manufactured_forcing_is_the_laplacian():
    """Each equation's forcing is its solution's operator, checked by
    finite differences on NumPy arrays."""
    from perfbench.harness.spec import load_module
    rng = np.random.default_rng(3)
    x, y, h = rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20), 1e-4
    spec = {"k": [1.0, 2.0, 3.0]}

    def lap(fn):
        return (fn(x + h, y) + fn(x - h, y) + fn(x, y + h) + fn(x, y - h)
                - 4 * fn(x, y)) / h ** 2

    poisson = load_module(ROOT / "perfbench/equations/poisson.py", "t")
    p = poisson.draw(rng, spec)
    u = lambda a, b: poisson.exact(p, a, b)["u"]  # noqa: E731
    assert np.abs(lap(u) - poisson.forcing(p, x, y, np)[0]).max() < 1e-5
    assert np.abs(u(x, y) - poisson.boundary(p, x, y, np)[0]).max() == 0
    stokes = load_module(ROOT / "perfbench/equations/stokes.py", "t")
    p = stokes.draw(rng, spec)
    ex = lambda a, b: stokes.exact(p, a, b)  # noqa: E731
    fu, fv = stokes.forcing(p, x, y, np)
    px = (ex(x + h, y)["p"] - ex(x - h, y)["p"]) / (2 * h)
    py = (ex(x, y + h)["p"] - ex(x, y - h)["p"]) / (2 * h)
    assert np.abs(-lap(lambda a, b: ex(a, b)["u"]) + px - fu).max() < 1e-5
    assert np.abs(-lap(lambda a, b: ex(a, b)["v"]) + py - fv).max() < 1e-5
    div = ((ex(x + h, y)["u"] - ex(x - h, y)["u"])
           + (ex(x, y + h)["v"] - ex(x, y - h)["v"])) / (2 * h)
    assert np.abs(div).max() < 1e-7
