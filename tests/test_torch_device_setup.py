"""The port's "device" setup backend (forms born on the solver's device,
min-norm CholeskyQR2 QFS composes, device-assembled and -inverted BIEs with
one refinement pass) on CPU tensors, forced with IPDE_QFS_BACKEND=device.

* One QFS map pair on a small curve against ipde_tpu's device backend,
  compared by the field A xi of smooth densities on the curve (within 1e-11
  of its largest value: two min-norm composes of one exponentially
  ill-conditioned system in float64, whose fields agree to the rounding
  the pseudo-inverse amplifies).
* The interior Poisson Dirichlet, Stokes Dirichlet, Laplace Neumann and
  Yukawa (k = 2) Neumann solves of tests/test_device_setup_path.py
  (star(300, a=0.2, f=5), M=12) with the device backend: errors against the
  manufactured solutions within that file's limits (2e-10, 5e-9, 5e-9; the
  Laplace Neumann solve is held to the Neumann limit up to its constant),
  ``bie.A_dev`` kept, and the gap to the port's host-backend solve of the
  same problem within the same limit.
* ``auto_backend`` and ``_bie_backend``: "host" on the CPU unless
  overridden, the size rule on a CUDA device, bad overrides rejected.

Marker ``gpu``: the device-backend Poisson solve on the card against the
same solve on the CPU, skipped with a reason where torch sees no CUDA
device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_testing import fuf as _fuf, fvf as _fvf, pfrc as _frc
from _torch_testing import one_torch_thread  # noqa: F401
from _torch_testing import psol as _sol, usol as _usol, vsol as _vsol
from ipde_tpu.geometry.curve import star as jstar
from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary as JEB
from ipde_tpu.ops import singular as jsq
from ipde_tpu.qfs import qfs as jqfs
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.curve import star
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.qfs import qfs
from ipde_tpu_torch.solvers import bie as bie_mod
from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                        StokesDirichletBIE)
from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                           PoissonSolver)
from ipde_tpu_torch.solvers.vector import StokesSolver

LIMITS = {"poisson": 2e-10, "stokes": 5e-9, "laplace_neumann": 5e-9,
          "mh_neumann": 5e-9}
GRID_BACKEND = {"poisson": "fft", "stokes": "dense",
                "laplace_neumann": "dense", "mh_neumann": "fft"}
K = 2.0


@pytest.fixture
def no_override(monkeypatch):
    for name in ("IPDE_QFS_BACKEND", "IPDE_BIE_BACKEND",
                 "IPDE_QFS_DEVICE_MIN"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_qfs_device_backend_matches_ipde_tpu(no_override):
    """Laplace QFS (SLP and DLP forms, u2s) of the interface of star(200),
    M=10, on both packages' device backends: the maps are compressed to the
    curve's N, and the field A xi of each map's xi on the curve agrees."""
    bdy_args = dict(a=0.2, f=5)
    M = 10
    jb, tb = jstar(200, **bdy_args), star(200, **bdy_args)
    bh = min(tb.min_h(), 0.6 / np.abs(tb.curvature).max() / M)
    je = JEB(jb, True, M, bh, qfs_tolerance=1e-14)
    te = EmbeddedBoundary(tb, True, M, bh, qfs_tolerance=1e-14)
    jsrc = je.qfs_source_for_side("interface", interior_eval=True)
    tsrc = te.qfs_source_for_side("interface", interior_eval=True)
    jq = jqfs.laplace_qfs(je.interface, jsrc, True, backend="device")
    tq = qfs.laplace_qfs(te.interface, tsrc, True, backend="device",
                         device="cpu")
    n = te.interface.N
    assert [tuple(m.shape) for m in tq.mats] == [(n, n)] * 2
    assert tq.up is not None and tq.shifted_retries == 0
    t = te.interface.t
    taus = [np.exp(np.sin(t)), np.cos(3 * t) + 0.5 * np.sin(t)]
    A = jsq.laplace_slp_naive(jsrc, je.interface.x, je.interface.y)
    outs = [(jq([jnp.asarray(v) for v in taus]),
             tq([torch.as_tensor(v) for v in taus])),
            (jq.u2s(jnp.asarray(taus[0])), tq.u2s(torch.as_tensor(taus[0])))]
    for jxi, txi in outs:
        assert txi.shape == (tsrc.N,)
        want = A @ np.asarray(jxi)
        got = A @ txi.numpy()
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def _collection(device):
    bdy = star(300, a=0.2, f=5)
    M = 12
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    c = EmbeddedBoundaryCollection([ebdy], device=device)
    c.generate_grid(bh)
    return c


@pytest.fixture(scope="module")
def ebdyc():
    return _collection("cpu")


def _sol_grad(x, y):
    return ((np.sin(x) - np.cos(x) ** 2) * np.exp(np.sin(x)) * np.sin(y),
            -np.cos(x) * np.exp(np.sin(x)) * np.cos(y))


def _mh_sol(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y)


def _mh_frc(x, y):
    return ((K ** 2 + 4) * np.exp(np.sin(x)) * np.sin(2 * y)
            - (np.cos(x) ** 2 - np.sin(x)) * np.exp(np.sin(x))
            * np.sin(2 * y))


def _mh_grad(x, y):
    return (np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y),
            2 * np.exp(np.sin(x)) * np.cos(2 * y))


def _normal_data(ebdyc, grad):
    b = ebdyc.ebdys[0].bdy
    gx, gy = grad(b.x, b.y)
    return BoundaryFunction([torch.as_tensor(gx * b.normal_x
                                             + gy * b.normal_y,
                                             device=ebdyc.device)])


def _solve(problem, ebdyc):
    """(bie, the solution's u, the exact u) of one problem, on the grid
    backend that sets it up faster on the CPU (GRID_BACKEND: the FFT
    evaluators' tables and the dense kernel's plain version are no part of
    what the setup backend builds)."""
    gb = GRID_BACKEND[problem]
    ef = lambda fn: EmbeddedFunction.from_function(ebdyc, fn)  # noqa: E731
    if problem == "poisson":
        solver = PoissonSolver(ebdyc, grid_backend=gb)
        bie = DirichletBIE(solver)
        u = bie.apply_bc(solver(ef(_frc), tol=1e-13),
                         BoundaryFunction.from_function(ebdyc, _sol))
        return bie, u, ef(_sol)
    if problem == "laplace_neumann":
        solver = PoissonSolver(ebdyc, grid_backend=gb)
        bie = NeumannBIE(solver)
        u = bie.apply_bc(solver(ef(_frc), tol=1e-13),
                         _normal_data(ebdyc, _sol_grad))
        return bie, u, ef(_sol)
    if problem == "mh_neumann":
        solver = ModifiedHelmholtzSolver(ebdyc, k=K, grid_backend=gb)
        bie = NeumannBIE(solver)
        u = bie.apply_bc(solver(ef(_mh_frc), tol=1e-13),
                         _normal_data(ebdyc, _mh_grad))
        return bie, u, ef(_mh_sol)
    solver = StokesSolver(ebdyc, grid_backend=gb)
    bie = StokesDirichletBIE(solver)
    u, v, p = solver(ef(_fuf), ef(_fvf), tol=1e-12)
    u, _, _ = bie.apply_bc(u, v, p,
                           BoundaryFunction.from_function(ebdyc, _usol),
                           BoundaryFunction.from_function(ebdyc, _vsol))
    return bie, u, ef(_usol)


def _gap(ebdyc, a, b, shift=0.0):
    """max |a - b - shift| over the physical grid points and the radial
    grid."""
    phys = torch.as_tensor(ebdyc.phys, device=a.grid.device)
    return max(float((a.grid - b.grid - shift)[phys].abs().max()),
               float((a.radials[0] - b.radials[0] - shift).abs().max()))


@pytest.mark.parametrize("problem", sorted(LIMITS))
def test_device_setup_solve(problem, ebdyc, no_override):
    no_override.setenv("IPDE_QFS_BACKEND", "device")
    bie, u, exact = _solve(problem, ebdyc)
    assert bie.A_dev is not None
    qfs_maps = bie.qfs_list + [q for h in bie.solver.helpers
                               for q in (h.qfs_g, h.qfs_r)]
    assert all(q.up is not None for q in qfs_maps)
    # a pure Neumann Laplace solution is unique up to a constant
    shift = 0.0
    if problem == "laplace_neumann":
        phys = torch.as_tensor(ebdyc.phys)
        shift = float((u.grid - exact.grid)[phys].mean())
    err = _gap(ebdyc, u, exact, shift)
    no_override.setenv("IPDE_QFS_BACKEND", "host")
    host_bie, host_u, _ = _solve(problem, ebdyc)
    assert host_bie.A_dev is None
    gap = _gap(ebdyc, u, host_u)
    print(f"{problem}: device-backend error {err:.3e} (host-backend "
          f"{_gap(ebdyc, host_u, exact, shift):.3e}), gap {gap:.3e}")
    assert err < LIMITS[problem]
    assert gap < LIMITS[problem]


def test_auto_backend_rules(no_override):
    cuda = torch.device("cuda", 0)
    assert qfs.auto_backend(10 ** 6, "cpu") == "host"
    assert qfs.auto_backend(qfs.DEVICE_MIN, cuda) == "device"
    assert qfs.auto_backend(qfs.DEVICE_MIN - 1, cuda) == "host"
    no_override.setenv("IPDE_QFS_DEVICE_MIN", "500")
    assert qfs.auto_backend(499, cuda) == "host"
    assert qfs.auto_backend(500, cuda) == "device"
    no_override.setenv("IPDE_QFS_BACKEND", "device")
    assert qfs.auto_backend(10, "cpu") == "device"
    assert bie_mod._bie_backend(10, "cpu") == "device"
    no_override.setenv("IPDE_BIE_BACKEND", "host")
    assert bie_mod._bie_backend(10, "cpu") == "host"
    no_override.setenv("IPDE_BIE_BACKEND", "gpu")
    with pytest.raises(ValueError):
        bie_mod._bie_backend(10, "cpu")
    no_override.setenv("IPDE_QFS_BACKEND", "gpu")
    with pytest.raises(ValueError):
        qfs.auto_backend(10, "cpu")


def test_failed_compose_raises():
    """A Gram matrix that stays indefinite after the shifted retries
    raises; nothing falls back to another backend."""
    A = torch.zeros((4, 4), dtype=torch.float64)
    A[0, 0] = float("nan")
    with pytest.raises(torch.linalg.LinAlgError):
        qfs._minnorm_compose(A, [torch.eye(4, dtype=torch.float64)])


@pytest.mark.gpu
def test_device_setup_on_cuda_matches_cpu(ebdyc, no_override):
    """The device-backend Poisson solve with the collection on the card
    against the same solve on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    no_override.setenv("IPDE_QFS_BACKEND", "device")
    card = _collection("cuda")
    bie, u, exact = _solve("poisson", card)
    assert bie.A_dev.is_cuda
    _, cpu_u, _ = _solve("poisson", ebdyc)
    err = _gap(card, u, exact)
    gap = max(float((u.grid.cpu() - cpu_u.grid).abs().max()),
              float((u.radials[0].cpu() - cpu_u.radials[0]).abs().max()))
    assert err < LIMITS["poisson"]
    assert gap < 1e-11
