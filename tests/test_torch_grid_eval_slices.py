"""The whole fft slices of the port (its default grid backend, the
free-space FFT evaluators of ipde_tpu_torch.ops.grid_eval) against
ipde_tpu's default (fft) solves, both packages built from one saved
geometry: Poisson + DirichletBIE on the problem of __graft_entry__.entry()
(star(128, a=0.1, f=3), M=8), modified Helmholtz + DirichletBIE (k = 2) and
+ NeumannBIE (k = 20) on the same curve, and Stokes + StokesDirichletBIE on
star(128, a=0.1, f=5), M=8 (the geometries of tests/test_torch_solvers.py,
test_torch_mh.py and test_torch_stokes.py).  The evaluators alone are held
in tests/test_torch_grid_eval.py.

Tolerances: 1e-10 absolute on the O(1) solutions (GMRES stops at 1e-12 and
the sums run in another order), as tests/test_torch_solvers.py holds the
dense slice; iterations within one; the manufactured-solution errors within
a factor 2 of ipde_tpu's."""

import functools
import time

import numpy as np
import pytest
import torch

import ipde_tpu.native
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.solvers.bie import DirichletBIE as JBIE
from ipde_tpu.solvers.bie import NeumannBIE as JNBIE
from ipde_tpu.solvers.bie import StokesDirichletBIE as JSBIE
from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver as JMH
from ipde_tpu.solvers.scalar import PoissonSolver as JPS
from ipde_tpu.solvers.vector import StokesSolver as JSS
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                        StokesDirichletBIE)
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

NB, M = 128, 8
SOLVE = dict(tol=1e-12, maxiter=60, restart=30)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module.  The tier-1 command runs six
    workers on eight cores, where torch's OpenMP threads oversubscribe the
    CPU: the port's CPU paths here then run several times slower than on
    one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)



def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


# the manufactured solution of tests/test_torch_mh.py
def mh_sol(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y) + 0.3 * np.cos(3 * x) * np.cos(y)


def mh_lap_sol(x, y):
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    return u1xx - 4 * u1 - 10 * 0.3 * np.cos(3 * x) * np.cos(y)


def mh_grad_sol(x, y):
    ux = (np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y)
          - 0.9 * np.sin(3 * x) * np.cos(y))
    uy = (2 * np.exp(np.sin(x)) * np.cos(2 * y)
          - 0.3 * np.cos(3 * x) * np.sin(y))
    return ux, uy


# bench.py's Stokes manufactured solution
def usol(x, y):
    return np.sin(x) * np.cos(y) + 0.2 * np.cos(2 * y)


def vsol(x, y):
    return -np.cos(x) * np.sin(y) + 0.1 * np.sin(2 * x)


def fuf(x, y):
    return (2 * np.sin(x) * np.cos(y) + 0.8 * np.cos(2 * y)
            - np.sin(x) * np.sin(y))


def fvf(x, y):
    return (-2 * np.cos(x) * np.sin(y) + 0.4 * np.sin(2 * x)
            + np.cos(x) * np.cos(y))


@functools.lru_cache(maxsize=1)
def _collections(f):
    """star(NB, a=0.1, f=f), M: the ipde_tpu collection and the port's,
    loaded from its save, both with a grid; the scalar slices share the
    f = 3 pair (their solvers keep no state on it but the bump)."""
    for _ in range(20):   # see test_torch_geometry.pair
        if ipde_tpu.native.get_lib() is not None:
            break
        time.sleep(0.5)
    assert ipde_tpu.native.get_lib() is not None
    bdy = jstar(NB, a=0.1, f=f)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-12)])
    jc.generate_grid(bh)
    tc = load_collection(jc.save(), "cpu")
    tc.generate_grid(bh)
    return jc, tc


def _mms_err(ebdyc, ue, f):
    e = ebdyc.ebdys[0]
    g = np.abs(_np(ue.grid) - f(ebdyc.grid.xg, ebdyc.grid.yg))[ebdyc.phys]
    r = np.abs(_np(ue.radials[0]) - f(e.radial_x, e.radial_y))
    return max(g.max(), r.max())


def _scalar_slice(k, neumann):
    """Both packages' default (fft) solve + BIE correction: Poisson (k None,
    entry()'s problem) or modified Helmholtz."""
    jc, tc = _collections(3)
    if k is None:
        u, f = sol, frc
        js, ts = JPS(jc), PoissonSolver(tc)
    else:
        u = mh_sol
        f = lambda x, y: k**2 * mh_sol(x, y) - mh_lap_sol(x, y)  # noqa: E731
        js, ts = JMH(jc, k=k), ModifiedHelmholtzSolver(tc, k=k)
    if neumann:
        b = jc.ebdys[0].bdy
        ux, uy = mh_grad_sol(b.x, b.y)
        jbc = JBF([ux * b.normal_x + uy * b.normal_y])
        jb, tb = JNBIE(js), NeumannBIE(ts)
    else:
        jbc = JBF.from_function(jc, u)
        jb, tb = JBIE(js), DirichletBIE(ts)
    jf = JEF.from_function(jc, f)
    jue_raw, jst = js.solve_with_stats(jf, **SOLVE)
    jue = jb.apply_bc(jue_raw, jbc)
    ue_raw, st = ts.solve_with_stats(EmbeddedFunction.load(jf.save(), "cpu"),
                                     **SOLVE)
    ue = tb.apply_bc(ue_raw, BoundaryFunction(
        [torch.tensor(np.asarray(v)) for v in jbc.values]))
    assert (js.grid_backend, ts.grid_backend) == ("fft", "fft")
    assert tb.grid_eval is not None
    return dict(jc=jc, tc=tc, jue=jue, jst=jst, ue=ue, st=st, u=u)


@pytest.mark.parametrize("k,neumann", [(None, False), (2.0, False),
                                       (20.0, True)])
def test_whole_fft_slice_matches_reference(k, neumann):
    p = _scalar_slice(k, neumann)
    st, ue, jue = p["st"], p["ue"], p["jue"]
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert abs(st["annular_iterations"][0]
               - int(p["jst"]["annular_iterations"][0])) <= 1
    diff = max(np.abs(_np(ue.grid) - _np(jue.grid)).max(),
               np.abs(_np(ue.radials[0]) - _np(jue.radials[0])).max())
    print(f"k={k} neumann={neumann}: max |port - ipde_tpu| = {diff:.3e}")
    assert diff <= 1e-10
    terr, jerr = _mms_err(p["tc"], ue, p["u"]), _mms_err(p["jc"], jue, p["u"])
    assert 0.5 * jerr <= terr <= 2.0 * jerr, (terr, jerr)


def test_whole_stokes_fft_slice_matches_reference():
    jc, tc = _collections(5)
    js, ts = JSS(jc), StokesSolver(tc)
    jb, tb = JSBIE(js), StokesDirichletBIE(ts)
    assert (js.grid_backend, ts.grid_backend) == ("fft", "fft")
    jfu, jfv = JEF.from_function(jc, fuf), JEF.from_function(jc, fvf)
    jraw, jst = js.solve_with_stats(jfu, jfv, **SOLVE)
    ju, jv, jp = jb.apply_bc(*jraw, JBF.from_function(jc, usol),
                             JBF.from_function(jc, vsol))
    raw, st = ts.solve_with_stats(EmbeddedFunction.load(jfu.save(), "cpu"),
                                  EmbeddedFunction.load(jfv.save(), "cpu"),
                                  **SOLVE)
    u, v, p = tb.apply_bc(*raw, BoundaryFunction.from_function(tc, usol),
                          BoundaryFunction.from_function(tc, vsol))
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert abs(st["annular_iterations"][0]
               - int(jst["annular_iterations"][0])) <= 1
    phys = tc.phys
    for g, w in ((u, ju), (v, jv)):
        assert np.abs(_np(g.grid) - _np(w.grid))[phys].max() <= 1e-10
        assert np.abs(_np(g.radials[0]) - _np(w.radials[0])).max() <= 1e-10
    # the pressure up to a constant
    dg = (_np(p.grid) - _np(jp.grid))[phys]
    c = dg.mean()
    assert max(np.abs(dg - c).max(),
               np.abs(_np(p.radials[0]) - _np(jp.radials[0]) - c).max()) \
        <= 1e-10
    for g, w, f in ((u, ju, usol), (v, jv, vsol)):
        terr, jerr = _mms_err(tc, g, f), _mms_err(jc, w, f)
        assert 0.5 * jerr <= terr <= 2.0 * jerr, (terr, jerr)
