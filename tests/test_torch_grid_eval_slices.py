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

import numpy as np
import pytest
import torch

import _torch_testing as tt
from _torch_testing import SOLVE, as_np as _np, fuf, fvf, usol, vsol
from _torch_testing import one_torch_thread  # noqa: F401
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction

NB, M = 128, 8
# the entry() curve (f = 3: Poisson and the Yukawa slices), and the Stokes
# one (f = 5)
STARS = {f: (tt.body(NB, M, a=0.1, f=f),) for f in (3, 5)}


def _scalar_slice(k, neumann):
    """Both packages' default (fft) solve + BIE correction: Poisson (k None,
    entry()'s problem) or modified Helmholtz."""
    bodies = STARS[3]
    h = tt.one_body_h(bodies[0])
    jc, tc = tt.paired_collections(bodies, h)
    if k is None:
        pde, u, f = "poisson", tt.psol, tt.pfrc
    else:
        pde, u, f = "mh", tt.msol, tt.mh_forcing(k)
    problem = dict(k=k, grid_backend="fft")
    bc = tt.mgrad if neumann else u
    ref = tt.reference_solve(bodies, h, pde, (f,), (bc,), neumann=neumann,
                             **problem)
    ts = tt.port_solver(bodies, h, pde, **problem)
    tb = tt.port_bie(bodies, h, pde, neumann=neumann, **problem)
    ue_raw, st = ts.solve_with_stats(
        EmbeddedFunction.load(ref["jf"][0].save(), "cpu"), **SOLVE)
    ue = tb.apply_bc(ue_raw, BoundaryFunction(
        [torch.tensor(np.asarray(v)) for v in ref["jbc"][0].values]))
    assert (ref["js"].grid_backend, ts.grid_backend) == ("fft", "fft")
    assert tb.grid_eval is not None
    return dict(jc=jc, tc=tc, jue=ref["jue"], jst=ref["jst"], ue=ue, st=st,
                u=u)


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
    terr = tt.mms_err(p["tc"], ue, p["u"])
    jerr = tt.mms_err(p["jc"], jue, p["u"])
    assert 0.5 * jerr <= terr <= 2.0 * jerr, (terr, jerr)


def test_whole_stokes_fft_slice_matches_reference():
    bodies = STARS[5]
    h = tt.one_body_h(bodies[0])
    jc, tc = tt.paired_collections(bodies, h)
    ref = tt.reference_solve(bodies, h, "stokes", (fuf, fvf), (usol, vsol),
                             grid_backend="fft")
    ts = tt.port_solver(bodies, h, "stokes", grid_backend="fft")
    tb = tt.port_bie(bodies, h, "stokes", grid_backend="fft")
    assert (ref["js"].grid_backend, ts.grid_backend) == ("fft", "fft")
    jst, (ju, jv, jp) = ref["jst"], ref["jue"]
    jfu, jfv = ref["jf"]
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
        terr, jerr = tt.mms_err(tc, g, f), tt.mms_err(jc, w, f)
        assert 0.5 * jerr <= terr <= 2.0 * jerr, (terr, jerr)
