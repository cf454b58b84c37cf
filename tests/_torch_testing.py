"""The shared scaffold of the port's parity tests (tests/test_torch_*.py).

pytest does not collect this file (its name matches no ``test_*.py``), and
``tests/`` is on ``sys.path`` under pytest's default import mode.  Every port
test module takes its thread rule from here::

    from _torch_testing import one_torch_thread  # noqa: F401

and builds the problems it holds to ``ipde_tpu`` with the cached builders
below: ``paired_collections`` (one saved geometry in both packages),
``reference_solve`` (``ipde_tpu``'s solver, BIE and solve of one problem)
and ``port_solver`` / ``port_bie``.  Each is cached on the arguments that
define its problem, so that the modules a worker runs share one build of
it, above all one ``ipde_tpu`` set-up and reference solve.

What the builders return is shared, so it is read-only.  A test that
monkeypatches a module the solve calls, captures or replans, runs under
``use_mesh``, sets a set-up-backend environment variable, or mutates a
solver, collection or function builds its own objects.  A build depends on
its arguments only: the cache key holds every input that reaches it, the
set-up-backend variables of both packages included (``SETUP_VARS``, read
into the key and nowhere else).

The manufactured solutions and the small comparison helpers here are the
ones two or more modules held copies of."""

import collections
import contextlib
import functools
import inspect
import os
import time

import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (its BLAS is loaded before the limit)
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:
    # the card's machine lacks it; its gpu-marked tests run in one process
    threadpool_limits = None

import ipde_tpu.native
from ipde_tpu.functions import BoundaryFunction as JBF
from ipde_tpu.functions import EmbeddedFunction as JEF
from ipde_tpu.geometry import curve as jcurves
from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection as JEBC
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.ops.stratified import StratifiedRadialApply as JSRA
from ipde_tpu.solvers.bie import DirichletBIE as JDBIE
from ipde_tpu.solvers.bie import NeumannBIE as JNBIE
from ipde_tpu.solvers.bie import StokesDirichletBIE as JSBIE
from ipde_tpu.solvers.scalar import ModifiedHelmholtzSolver as JMHS
from ipde_tpu.solvers.scalar import PoissonSolver as JPS
from ipde_tpu.solvers.vector import StokesSolver as JSS
from ipde_tpu_torch.geometry.collection import load_collection
from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                        StokesDirichletBIE)
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

# the GMRES options of most parity solves
SOLVE = dict(tol=1e-12, maxiter=60, restart=30)
# the environment variables that choose either package's set-up backend
SETUP_VARS = ("IPDE_QFS_BACKEND", "IPDE_BIE_BACKEND", "IPDE_QFS_DEVICE_MIN")
NO_CUDA = "needs a CUDA device (torch.cuda.is_available() is False)"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread and one BLAS thread for the module that imports
    this fixture; the counts it found come back after the module.  The
    tier-1 command runs six workers on eight cores: there torch's OpenMP
    threads and the BLAS threads of the host set-up (numpy, scipy) of six
    processes oversubscribe the CPU, and the port's CPU paths run many
    times slower than on one thread.  The BLAS limit needs threadpoolctl,
    which the tier-1 machine has."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = (threadpool_limits(limits=1, user_api="blas") if threadpool_limits
            else contextlib.nullcontext())
    try:
        with blas:
            yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# manufactured solutions
# ---------------------------------------------------------------------------

# Poisson: __graft_entry__.entry()'s problem (lap psol = pfrc)
def psol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def pfrc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


# modified Helmholtz: tests/test_interior_mh.py, test_neumann.py and
# test_multi_body.py (lap msol = mlap, grad msol = mgrad)
def msol(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y) + 0.3 * np.cos(3 * x) * np.cos(y)


def mlap(x, y):
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    return u1xx - 4 * u1 - 10 * 0.3 * np.cos(3 * x) * np.cos(y)


def mgrad(x, y):
    ux = (np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y)
          - 0.9 * np.sin(3 * x) * np.cos(y))
    uy = (2 * np.exp(np.sin(x)) * np.cos(2 * y)
          - 0.3 * np.cos(3 * x) * np.sin(y))
    return ux, uy


@functools.lru_cache(maxsize=None)
def mh_forcing(k):
    """k^2 msol - lap msol: the forcing of (k^2 - lap) u = f, one function
    object per k."""
    return lambda x, y: k ** 2 * msol(x, y) - mlap(x, y)


# Stokes: bench.py's (BENCH_PDE=stokes) and examples/stokes_refinement.py's
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


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def as_np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def rel(got, want):
    """max |got - want| / max |want|, of arrays of one shape."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def assert_close(got, want, rtol=1e-13):
    """rel(got, want) below rtol."""
    err = rel(got, want)
    assert err < rtol, err


def rel_gap(got, want, phys, shift=False):
    """max |got - want| over the physical grid points and every radial
    grid, relative to max |want| there; ``shift``: less the mean of
    got - want on the physical grid (a pressure)."""
    g, w = as_np(got.grid), as_np(want.grid)
    c = (g - w)[phys].mean() if shift else 0.0
    scale = max(np.abs(w)[phys].max(),
                max(np.abs(as_np(r)).max() for r in want.radials))
    gap = max(np.abs(g - w - c)[phys].max(),
              max(np.abs(as_np(a) - as_np(b) - c).max()
                  for a, b in zip(got.radials, want.radials)))
    return gap / scale


def mms_err(ebdyc, ef, f):
    """max |ef - f| over the physical grid points and the radial nodes of
    every boundary."""
    g = ebdyc.grid
    return max(np.abs(as_np(ef.grid) - f(g.xg, g.yg))[ebdyc.phys].max(),
               max(np.abs(as_np(r) - f(e.radial_x, e.radial_y)).max()
                   for r, e in zip(ef.radials, ebdyc.ebdys)))


def ds_round(x):
    """x rounded to a double-single pair (the Pallas kernels' inputs)."""
    hi = x.astype(np.float32).astype(np.float64)
    lo = (x - hi).astype(np.float32).astype(np.float64)
    return hi + lo


def cloud(T=700, S=300, seed=0, near=True):
    """tests/test_pallas_ds.py's cloud (sx, sy, q, tx, ty): sources on a
    perturbed circle, targets inside, the first 32 near-coincident."""
    rng = np.random.default_rng(seed)
    sx = np.cos(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    sy = np.sin(2 * np.pi * np.arange(S) / S) * (1 + 0.05 * rng.standard_normal(S))
    r = 0.8 * np.sqrt(rng.uniform(0.01, 1, T))
    th = rng.uniform(0, 2 * np.pi, T)
    tx = r * np.cos(th)
    ty = r * np.sin(th)
    if near:
        k = min(32, T, S)
        tx[:k] = sx[:k] + 10.0 ** rng.uniform(-4, -2, k)
        ty[:k] = sy[:k] + 10.0 ** rng.uniform(-4, -2, k)
    q = rng.standard_normal(S) / S
    return tuple(ds_round(a) for a in (sx, sy, q, tx, ty))


def cuda_or_skip():
    """The first CUDA device; skips the test where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CUDA)
    return torch.device("cuda", 0)


def cards_or_skip():
    """Every CUDA device torch sees; skips the test where it sees none."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CUDA)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def plans_as_port(jbie):
    """Give an ipde_tpu BIE the port's radial plans: every source, except
    on an interior boundary's own rows (solvers/bie.py::_radial_plans).
    ipde_tpu subsamples them, which costs its three-body Stokes problem
    three orders of accuracy."""
    for i, e in enumerate(jbie.ebdyc):
        for j, (src, ej) in enumerate(zip(jbie.src_list, jbie.ebdyc)):
            if not (i == j and e.interior):
                jbie.radial_plans[i][j] = JSRA(src, e.radial_x, e.radial_y,
                                               k_density=ej.bdy.N // 2,
                                               max_stride=1)
    return jbie


# ---------------------------------------------------------------------------
# paired problems
# ---------------------------------------------------------------------------

def wait_native():
    """Wait for ipde_tpu's native coordinate library: the reference's
    coordinates come from it too, and it falls back to numpy silently when
    a concurrent build races it."""
    for _ in range(20):
        if ipde_tpu.native.get_lib() is not None:
            break
        time.sleep(0.5)
    assert ipde_tpu.native.get_lib() is not None


def cached(build):
    """``build`` cached on its arguments, defaults filled in (a call that
    spells out a default is the same problem), and on the set-up-backend
    variables (``SETUP_VARS``), which reach either package's set-up."""
    sig = inspect.signature(build)

    @functools.lru_cache(maxsize=None)
    def keyed(env, args, kwargs):
        return build(*args, **dict(kwargs))

    @functools.wraps(build)
    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return keyed(tuple(os.environ.get(v) for v in SETUP_VARS),
                     bound.args, tuple(sorted(bound.kwargs.items())))

    return call


# A boundary: curve (the name of a curve of both packages' geometry.curve),
# its point count and keyword arguments, interior or an inclusion, M and
# the QFS tolerance.
Body = collections.namedtuple("Body", "curve nb kw interior M qfs_tolerance")


def body(nb, M, interior=True, qfs_tolerance=1e-12, curve="star", **kw):
    """The Body of ``curve(nb, **kw)`` (a hashable key)."""
    return Body(curve, nb, tuple(sorted(kw.items())), interior, M,
                qfs_tolerance)


def jcurve(b):
    """ipde_tpu's curve of Body ``b``."""
    return getattr(jcurves, b.curve)(b.nb, **dict(b.kw))


def one_body_h(b):
    """The grid spacing of a one-boundary problem: the boundary's smallest
    spacing, or 0.6 / (M max |curvature|) where that is smaller."""
    c = jcurve(b)
    return min(c.min_h(), 0.6 / np.abs(c.curvature).max() / b.M)


def two_body():
    """An interior star(64, a=0.1, f=3) and one inclusion of its (n, M) =
    (64, 6), where both packages take the lockstep annular GMRES: (Bodies,
    h)."""
    M = 6
    bodies = (body(64, M, a=0.1, f=3),
              body(64, M, False, x=0.1, y=-0.05, r=0.35, a=0.05, f=3))
    outer, inner = map(jcurve, bodies)
    return bodies, min(outer.min_h(), inner.min_h(),
                       0.6 / np.abs(inner.curvature).max() / M)


@cached
def paired_collections(bodies, h, pad_quantum=None):
    """(ipde_tpu's collection of ``bodies`` with its grid of spacing ``h``,
    the port's on the CPU loaded from its save, with the same grid)."""
    wait_native()
    jc = JEBC([JEB(jcurve(b), b.interior, b.M, h,
                   qfs_tolerance=b.qfs_tolerance) for b in bodies])
    jc.generate_grid(h, pad_quantum=pad_quantum)
    tc = load_collection(jc.save(), "cpu")
    tc.generate_grid(h, pad_quantum=pad_quantum)
    return jc, tc


def _solver(classes, c, pde, k, grid_backend, solver_type):
    S = dict(zip(("poisson", "mh", "stokes"), classes))[pde]
    kw = dict(grid_backend=grid_backend, solver_type=solver_type)
    return S(c, k=k, **kw) if pde == "mh" else S(c, **kw)


@cached
def reference_solver(bodies, h, pde, k=None, grid_backend="dense",
                     solver_type="spectral"):
    """ipde_tpu's solver ("poisson", "mh" with its k, "stokes") on
    ``paired_collections(bodies, h)``."""
    jc, _ = paired_collections(bodies, h)
    return _solver((JPS, JMHS, JSS), jc, pde, k, grid_backend, solver_type)


@cached
def port_solver(bodies, h, pde, k=None, grid_backend="dense",
                solver_type="spectral"):
    """The port's solver of the same problem on the port's collection."""
    _, tc = paired_collections(bodies, h)
    return _solver((PoissonSolver, ModifiedHelmholtzSolver, StokesSolver),
                   tc, pde, k, grid_backend, solver_type)


@cached
def port_bie(bodies, h, pde, k=None, grid_backend="dense",
             solver_type="spectral", neumann=False):
    """The port's BIE (Dirichlet, Neumann, or Stokes Dirichlet) on
    ``port_solver`` of the same arguments."""
    ts = port_solver(bodies, h, pde, k, grid_backend, solver_type)
    if pde == "stokes":
        return StokesDirichletBIE(ts)
    return (NeumannBIE if neumann else DirichletBIE)(ts)


def normal_derivative(ebdyc, grad):
    """The values of grad . n on each boundary of ``ebdyc``."""
    return [sum(g * n for g, n in zip(grad(e.bdy.x, e.bdy.y),
                                      (e.bdy.normal_x, e.bdy.normal_y)))
            for e in ebdyc.ebdys]


@cached
def reference_solve(bodies, h, pde, forcing, bc, k=None, neumann=False,
                    grid_backend="dense", solver_type="spectral",
                    port_plans=False, tol=SOLVE["tol"],
                    maxiter=SOLVE["maxiter"], restart=SOLVE["restart"]):
    """ipde_tpu's solve of one problem on ``paired_collections(bodies,
    h)``.  ``forcing``: the forcing functions (one; two for Stokes);
    ``bc``: the Dirichlet data's functions, or with ``neumann`` the
    gradient whose normal component is the data; ``port_plans``: the BIE
    takes the port's radial plans; ``tol``, ``maxiter``, ``restart``: the
    GMRES options.  A dict: js, jb, jf and jbc (ipde_tpu's forcing and
    boundary data), jraw and jst (the inhomogeneous solve and its stats),
    jue (its BIE correction)."""
    jc, _ = paired_collections(bodies, h)
    js = reference_solver(bodies, h, pde, k, grid_backend, solver_type)
    jf = [JEF.from_function(jc, f) for f in forcing]
    if neumann:
        jbc = [JBF(normal_derivative(jc, bc[0]))]
        jb = JNBIE(js)
    else:
        jbc = [JBF.from_function(jc, g) for g in bc]
        jb = JSBIE(js) if pde == "stokes" else JDBIE(js)
    if port_plans:
        plans_as_port(jb)
    jraw, jst = js.solve_with_stats(*jf, tol=tol, maxiter=maxiter,
                                    restart=restart)
    jue = jb.apply_bc(*(jraw if isinstance(jraw, tuple) else (jraw,)),
                      *jbc)
    return dict(js=js, jb=jb, jf=jf, jbc=jbc, jraw=jraw, jst=jst, jue=jue)
