"""The port's solve path against ipde_tpu: annular operators and GMRES
solve, QFS maps, stratified radial applies, the Dirichlet BIE, and the whole
interior Poisson slice (PoissonSolver(grid_backend="dense") + DirichletBIE)
on the problem of __graft_entry__.entry() (star(128, a=0.1, f=3), M=8),
both packages built from one saved geometry.  Also: the port imports no
jax, its own MMS convergence at nb=400, M=16, and (marker ``gpu``) the
slice on a CUDA device against the slice on the CPU.

Tolerances are relative to the largest value compared: 1e-13 for single
operator applies (the same float64 sums in another order); the looser ones
are stated where they are used."""

import inspect
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipde_tpu.native
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.ops import kernels as jkernels
from ipde_tpu.solvers import annular_scalar as jann
from ipde_tpu.solvers.bie import DirichletBIE as JBIE
from ipde_tpu.solvers.scalar import PoissonSolver as JPS
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                load_collection)
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels
from ipde_tpu_torch.solvers import annular_scalar as ann
from ipde_tpu_torch.solvers.bie import DirichletBIE
from ipde_tpu_torch.solvers.scalar import PoissonSolver, ScalarSolver

ROOT = Path(__file__).resolve().parents[1]
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


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _mms_err(ebdyc, ue):
    e = ebdyc.ebdys[0]
    g = np.abs(_np(ue.grid) - sol(ebdyc.grid.xg, ebdyc.grid.yg))[ebdyc.phys]
    r = np.abs(_np(ue.radials[0]) - sol(e.radial_x, e.radial_y))
    return max(g.max(), r.max())


@pytest.fixture(scope="module")
def problem():
    """entry()'s problem solved by ipde_tpu (dense grid backend), and the
    port's solver and BIE built from the saved geometry."""
    for _ in range(20):   # see test_torch_geometry.pair
        if ipde_tpu.native.get_lib() is not None:
            break
        time.sleep(0.5)
    assert ipde_tpu.native.get_lib() is not None
    bdy = jstar(NB, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    jc = JEBC([JEB(bdy, True, M, bh, qfs_tolerance=1e-12)])
    jc.generate_grid(bh)
    jf, jbc = JEF.from_function(jc, frc), JBF.from_function(jc, sol)
    js = JPS(jc, grid_backend="dense")
    jb = JBIE(js)
    jue_raw, jst = js.solve_with_stats(jf, **SOLVE)
    jue = jb.apply_bc(jue_raw, jbc)
    tc = load_collection(jc.save(), "cpu")
    tc.generate_grid(bh)
    ts = PoissonSolver(tc, grid_backend="dense")
    tb = DirichletBIE(ts)
    return dict(jc=jc, js=js, jb=jb, jf=jf, jbc=jbc, jue_raw=jue_raw,
                jue=jue, jst=jst, tc=tc, ts=ts, tb=tb,
                tf=EmbeddedFunction.load(jf.save(), "cpu"),
                tbc=BoundaryFunction.from_function(tc, sol))


def test_annular_matvec_and_precond(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    jops = jh.annular_solver.make_ops(jh.metric)
    tops = th.annular_solver.make_ops(th.metric)
    Mr, n = th.annular_solver.M, th.annular_solver.n
    # the preconditioner blocks come from the same host numpy inverses
    assert np.array_equal(_np(jops.Kinv), _np(tops.Kinv))
    rng = np.random.default_rng(5)
    for k in range(2):
        u = rng.standard_normal(Mr * n)
        assert _rel(ann._matvec(tops, torch.as_tensor(u), Mr, n),
                    jann._matvec(jops, jnp.asarray(u), Mr, n)) < 1e-13
        assert _rel(ann._precond(tops, torch.as_tensor(u), Mr, n),
                    jann._precond(jops, jnp.asarray(u), Mr, n)) < 1e-13


def test_annular_solve(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    rng = np.random.default_rng(6)
    f = rng.standard_normal(th.annular_solver.geom.rv0.shape + (NB,))
    z = np.zeros(NB)
    ju, jst = jh.annular_solver.solve_with_stats(jh.metric, jnp.asarray(f),
                                                 z, z, **SOLVE)
    zt = torch.zeros(NB, dtype=torch.float64)
    tu, tst = th.annular_solver.solve_with_stats(th.metric, torch.as_tensor(f),
                                                 zt, zt, **SOLVE)
    assert tst["residual"] <= SOLVE["tol"]
    assert abs(tst["iterations"] - int(jst["iterations"])) <= 1
    # both stop at a 1e-12 relative residual: the solutions agree to that,
    # times the (preconditioned) operator's small condition number
    assert _rel(tu, ju) < 1e-11
    with pytest.raises(RuntimeError, match="did not converge"):
        th.annular_solver.solve_with_stats(th.metric, torch.as_tensor(f), zt,
                                           zt, tol=1e-12, maxiter=2,
                                           restart=2)


def test_qfs_maps_and_applies(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    # one host LAPACK composition from identical inputs
    for jq, tq in ((jh.qfs_g, th.qfs_g), (jh.qfs_r, th.qfs_r)):
        for jm, tm in zip(jq.mats, tq.mats):
            assert np.array_equal(_np(jm), _np(tm))
    assert th.qfs_g.u2s_mat is None
    assert np.array_equal(_np(jh.qfs_r.u2s_mat), _np(th.qfs_r.u2s_mat))
    assert np.array_equal(_np(jh.own_src_to_ifc), _np(th.own_src_to_ifc))
    rng = np.random.default_rng(7)
    slp, dlp = rng.standard_normal((2, NB))
    assert _rel(th.qfs_r([torch.as_tensor(slp), torch.as_tensor(dlp)]),
                jh.qfs_r([jnp.asarray(slp), jnp.asarray(dlp)])) < 1e-13
    assert _rel(th.qfs_r.u2s(torch.as_tensor(slp)),
                jh.qfs_r.u2s(jnp.asarray(slp))) < 1e-13


def test_stratified_radial_apply(problem):
    jh, th = problem["js"].helpers[0], problem["ts"].helpers[0]
    jp, tp = jh.radial_plan, th.radial_plan
    assert np.array_equal(jp.strides, tp.strides)
    rng = np.random.default_rng(8)
    sig = rng.standard_normal(th.radial_source.N)
    jsig, tsig = jnp.asarray(sig), torch.as_tensor(sig)
    want = jp.apply(lambda sx, sy, ws, f, tx, ty: jkernels.laplace_slp_apply(
        sx, sy, jsig[::f] * ws, tx, ty))
    got = tp.apply(lambda sx, sy, ws, f, tx, ty: kernels.laplace_slp_apply(
        sx, sy, tsig[::f] * ws, tx, ty))
    assert _rel(got, want) < 1e-13


def test_dirichlet_bie(problem):
    jb, tb = problem["jb"], problem["tb"]
    assert np.array_equal(_np(jb.Ainv), _np(tb.Ainv))
    # the BIE correction of one and the same inhomogeneous solution
    ue = EmbeddedFunction.load(problem["jue_raw"].save(), "cpu")
    got = tb.apply_bc(ue, problem["tbc"])
    want = problem["jue"]
    assert _rel(got.grid, want.grid) < 1e-13
    assert _rel(got.radials[0], want.radials[0]) < 1e-13


def test_whole_slice_matches_reference(problem):
    ts, tb = problem["ts"], problem["tb"]
    assert ts.grid_backend == "dense"
    ue_raw, st = ts.solve_with_stats(problem["tf"], **SOLVE)
    ue = tb.apply_bc(ue_raw, problem["tbc"])
    assert st["annular_residuals"][0] <= SOLVE["tol"]
    assert abs(st["annular_iterations"][0]
               - int(problem["jst"]["annular_iterations"][0])) <= 1
    # GMRES stops at 1e-12 and the sums are ordered differently: the two
    # packages agree to 1e-10 absolute on an O(1) solution
    jue = problem["jue"]
    assert np.abs(_np(ue.grid) - _np(jue.grid)).max() <= 1e-10
    assert np.abs(_np(ue.radials[0]) - _np(jue.radials[0])).max() <= 1e-10
    terr, jerr = _mms_err(ts.ebdyc, ue), _mms_err(problem["jc"], jue)
    assert 0.5 * jerr <= terr <= 2.0 * jerr, (terr, jerr)


def test_fft_backend_not_ported(problem):
    """The grid backend defaults to "fft", as in ipde_tpu; an unknown one
    raises ValueError."""
    assert inspect.signature(ScalarSolver).parameters["grid_backend"]\
        .default == "fft"
    with pytest.raises(ValueError, match="spectral"):
        PoissonSolver(problem["tc"], grid_backend="spectral")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ipde_tpu_torch\n"
        "for m in pkgutil.walk_packages(ipde_tpu_torch.__path__,\n"
        "                               'ipde_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, 'tools')\n"
        "import chip_smoke, torch_profile_solve\n"
        "assert 'ipde_tpu_torch.solvers.vector' in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'ipde_tpu')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_mms_convergence_nb400():
    """ipde_tpu's flagship MMS case (tests/test_interior_poisson.py) on the
    port alone: error below 5e-10 in fewer than 40 GMRES iterations."""
    bdy = star(400, a=0.2, f=5)
    Mr = 16
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / Mr)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, Mr, bh, qfs_tolerance=1e-14)],
        device="cpu")
    ebdyc.generate_grid(bh)
    solver = PoissonSolver(ebdyc)
    bie = DirichletBIE(solver)
    ue = bie.apply_bc(solver(EmbeddedFunction.from_function(ebdyc, frc),
                             tol=1e-12),
                      BoundaryFunction.from_function(ebdyc, sol))
    assert _mms_err(ebdyc, ue) < 5e-10
    assert solver.iteration_counts[0] < 40


@pytest.mark.gpu
def test_slice_on_cuda_matches_cpu():
    """entry()'s problem (star(128, a=0.1, f=3), M=8) solved by the port on
    the GPU and on the CPU: the kernel's and the plain version's sums differ
    in order only, and GMRES stops at 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    out = {}
    for dev in ("cpu", torch.device("cuda", 0)):
        bdy = star(128, a=0.1, f=3)
        bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / 8)
        ebdyc = EmbeddedBoundaryCollection(
            [EmbeddedBoundary(bdy, True, 8, bh, qfs_tolerance=1e-12)],
            device=dev)
        ebdyc.generate_grid(bh)
        solver = PoissonSolver(ebdyc)
        bie = DirichletBIE(solver)
        before = kernels.laplace_slp_apply.launches
        ue = bie.apply_bc(
            solver(EmbeddedFunction.from_function(ebdyc, frc), tol=1e-12,
                   maxiter=60, restart=30),
            BoundaryFunction.from_function(ebdyc, sol))
        out[str(dev)] = (ue.grid.cpu().numpy(), ue.radials[0].cpu().numpy(),
                         kernels.laplace_slp_apply.launches - before)
    (gc, rc, nc), (gg, rg, ng) = out["cpu"], out["cuda:0"]
    assert nc == 0 and ng > 0
    assert np.abs(gc - gg).max() <= 1e-11
    assert np.abs(rc - rg).max() <= 1e-11
