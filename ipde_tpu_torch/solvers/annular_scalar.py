"""Spectrally accurate scalar solvers on the annular strip.

Solves (helmholtz_k^2 - Lap) u = f on the boundary-fitted annulus with Robin
boundary conditions at both radial edges, using a Chebyshev-tau (radial) x
Fourier (tangential) discretization and right-preconditioned GMRES.

Reference semantics: ipde/annular/modified_helmholtz.py:90-203 and
ipde/annular/poisson.py.  The Krylov iteration runs in real space (Chebyshev
operators on the left, tangential derivatives by torch.fft on the right,
elementwise metric products); the preconditioner is the exact inverse of the
circle-approximation operator, applied per Fourier mode as one batched
product with the (nk, M, M) inverses built on the host.

Residual/unknown layout: u is (M, n) nodal values (row 0 = r=lb side);
residual rows = [PDE rows (M-2) ; lbc row ; ubc row], matching the RHS
[R02 @ f ; g_lb ; g_ub].

Several annuli of one (M, n) solve as one batch (``batched_annular_solve``):
their operator bundles are stacked on a leading axis and one lockstep GMRES
(``ops.gmres.batched_gmres``) applies all B matvecs and preconditioners in
each call, with one host read per chunk of iterations for the batch.  With a
mesh the batch is split along the boundary axis into per-device groups
(``shard_boundary_axis``).
"""

from __future__ import annotations

import copy
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.ops.fourier import (TanPlan, make_tan_plan, tan_deriv,
                                        tan_irfft, tan_rfft)
from ipde_tpu_torch.ops.gmres import batched_gmres, gmres
from ipde_tpu_torch.parallel.sharded import Mesh, gather, run_shards
from ipde_tpu_torch.utils.planify import recording
from ipde_tpu_torch.utils.profiling import spanned


class AnnularOps(NamedTuple):
    """Operator bundle for the annular scalar solve, on one device; in a
    batch (``stack_ops``) every tensor has a leading boundary axis and
    helm_k2 is a (B, 1, 1) tensor."""
    D01: torch.Tensor
    D12: torch.Tensor
    R01: torch.Tensor
    R12: torch.Tensor
    R02: torch.Tensor
    row_lb: torch.Tensor     # (1, M) combined Robin row at r=lb
    row_ub: torch.Tensor     # (1, M) combined Robin row at r=ub
    tan: TanPlan             # last-axis rfft/derivative plan
    Kinv: torch.Tensor       # (nk, M, M) per-mode preconditioner inverses
    psi1: torch.Tensor       # (M-1, n) metric
    inv_psi1: torch.Tensor
    inv_psi2: torch.Tensor   # (M-2, n)
    helm_k2: float           # k^2


def stack_ops(ops_list: Sequence[NamedTuple]) -> NamedTuple:
    """One bundle of B same-shape bundles (AnnularOps or StokesOps): each
    tensor stacked on a new leading axis (a vector as (B, 1, n), so that it
    broadcasts along rows as before), each float as a (B, 1, 1) tensor, the
    tangential plan shared."""
    first = ops_list[0]
    out = []
    for name, v in zip(first._fields, first):
        vals = [getattr(o, name) for o in ops_list]
        if isinstance(v, torch.Tensor):
            t = torch.stack(vals)
            out.append(t[:, None] if v.ndim == 1 else t)
        elif isinstance(v, float):
            # filled on the device (no host copy: a CUDA graph capture
            # takes it, the values fixed as a capture fixes any number)
            out.append(torch.stack([
                torch.full((1, 1), x, dtype=torch.float64,
                           device=first.D01.device) for x in vals]))
        else:
            out.append(v)
    return type(first)(*out)


def _ops_to(dev, ops: NamedTuple) -> NamedTuple:
    """A bundle with its tensors (its ``TanPlan``'s included) on ``dev``."""
    moved = []
    for v in ops:
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif isinstance(v, TanPlan) and v.ik.device != dev:
            v = copy.copy(v)
            v.ik = v.ik.to(dev)
        moved.append(v)
    return type(ops)(*moved)


def shard_boundary_axis(mesh, ops_list: Sequence[NamedTuple]):
    """The B same-shape bundles of ``ops_list`` in per-device groups along
    the boundary axis: [(device, rows, stacked bundle on that device)], the
    B rows split ``mesh.size`` ways as ``torch.tensor_split`` splits them,
    empty groups dropped (B is not padded).  The counterpart of
    ``ipde_tpu``'s shard_boundary_axis.  The split of the last ``ops_list``
    is kept on the mesh, so a solver's every solve stacks and copies its
    bundles once.  Inside a planified capture (``planify.recording``) the
    split is made anew and not kept: the captured stack and copies then
    read the plan buffers, which ``replan`` refills, and no eager solve
    reads a graph's memory."""
    key = tuple(map(id, ops_list))
    memo = mesh.boundary_groups
    capturing = recording() is not None
    if memo is not None and memo[0] == key and not capturing:
        return memo[2]
    splits = [(dev, rows) for dev, rows in zip(
        mesh.devices, torch.tensor_split(torch.arange(len(ops_list)),
                                         mesh.size)) if rows.numel() > 0]
    # each group's bundle stacked on the lead and copied to its device on
    # the group's stream (a copy to another card inside a capture must run
    # where the capture's fork reaches)
    moved = run_shards(mesh.lead, [
        (dev, functools.partial(_ops_to, dev, stack_ops(
            [ops_list[i] for i in rows.tolist()])))
        for dev, rows in splits])
    groups = [(dev, slice(int(rows[0]), int(rows[-1]) + 1), ops)
              for (dev, rows), ops in zip(splits, moved)]
    if not capturing:
        # the bundles are held with their ids, so no other list takes the
        # key
        mesh.boundary_groups = (key, list(ops_list), groups)
    return groups


def lockstep_maps(ops_list: Sequence[NamedTuple], mesh, fns, lead):
    """For each ``fn(bundle, v)`` of ``fns`` the (B, N) -> (B, N) map that
    ``batched_gmres`` takes: group by group of ``shard_boundary_axis`` over
    ``mesh`` (None: one group on ``lead``) on each group's device, a card
    group on a stream of its own (``parallel.sharded.run_shards``),
    gathered on ``lead`` in group order after the join (the Krylov basis,
    Hessenberg and host sync stay on ``lead``)."""
    groups = shard_boundary_axis(mesh or Mesh([lead]), ops_list)

    def job(fn, v, dev, rows, ops):
        return fn(ops, v[rows].to(dev)).to(lead)

    def apply(fn, v):
        return gather(run_shards(lead, [
            (dev, functools.partial(job, fn, v, dev, rows, ops))
            for dev, rows, ops in groups]), lead)
    return [functools.partial(apply, fn) for fn in fns]


def _matvec(ops: AnnularOps, u_flat: torch.Tensor, M: int,
            n: int) -> torch.Tensor:
    """A u for flat u of shape (M n,), or (B, M n) with batched ops."""
    u = u_flat.reshape(*u_flat.shape[:-1], M, n)
    du = ops.D01 @ u
    term1 = ops.D12 @ (ops.psi1 * du)
    ut = tan_deriv(u, ops.tan)
    w = (ops.R01 @ ut) * ops.inv_psi1
    term2 = ops.R12 @ tan_deriv(w, ops.tan)
    lu = (term1 + term2) * ops.inv_psi2
    top = ops.helm_k2 * (ops.R02 @ u) - lu
    return torch.cat([top, ops.row_lb @ u, ops.row_ub @ u],
                     dim=-2).reshape(u_flat.shape)


def _precond(ops: AnnularOps, r_flat: torch.Tensor, M: int,
             n: int) -> torch.Tensor:
    """The per-mode preconditioner on flat r of shape (M n,) or (B, M n)."""
    c = tan_rfft(r_flat.reshape(*r_flat.shape[:-1], M, n), ops.tan)
    # out[i, k] = sum_j Kinv[k, i, j] c[j, k]: one batched product over the
    # modes, on the (re, im) pairs of c
    cr = torch.view_as_real(c).transpose(-3, -2)            # (nk, M, 2)
    out = torch.matmul(ops.Kinv, cr).transpose(-3, -2).contiguous()
    return tan_irfft(torch.view_as_complex(out),
                     ops.tan).reshape(r_flat.shape)


def check_converged(label: str, residual: float, iterations: int,
                    tol: float, maxiter: int, restart: int):
    """Raise when GMRES ended with its true residual above tol."""
    if not residual <= tol:
        raise RuntimeError(
            f"{label} GMRES did not converge: residual {residual:.3e} > tol "
            f"{tol:.1e} after {iterations} iterations (maxiter {maxiter}, "
            f"restart {restart})")


def batched_annular_solve(solvers, metrics, rhss, tol: float = 1e-12,
                          maxiter: int = 200, restart: int = 40, mesh=None):
    """Solve B same-shape annular problems in one lockstep GMRES.

    solvers/metrics are per boundary (one (M, n) for all); rhss is a list of
    (M, n) right-hand sides already in residual layout (``build_rhs``).
    With a ``mesh`` (``parallel.sharded.Mesh``) the boundary axis is split
    over its devices (``shard_boundary_axis``): each group's matvec and
    preconditioner run on its device, the Krylov basis, Hessenberg and host
    sync stay on the right-hand sides' device.  Returns (list of (M, n)
    solutions, {'iterations': [B 0-d int64 tensors], 'residual': [B 0-d
    float64 tensors]}, on the right-hand sides' device); raises as
    ``solve_with_stats`` does when a system's true residual ends above tol,
    once GMRES has read it on the host (at every replay of a planified
    call)."""
    M, n = solvers[0].M, solvers[0].n
    b = torch.stack([r.reshape(-1) for r in rhss])
    mv, pc = lockstep_maps([s.make_ops(m) for s, m in zip(solvers, metrics)],
                           mesh, (lambda o, v: _matvec(o, v, M, n),
                                  lambda o, v: _precond(o, v, M, n)),
                           b.device)
    res = batched_gmres(mv, b, precond=pc, tol=tol, maxiter=maxiter,
                        restart=restart)
    res.on_host(lambda its, rs: converged_all("annular", solvers, its, rs,
                                              tol, maxiter, restart))
    return ([x.reshape(M, n) for x in res.x],
            {"iterations": list(res.iterations),
             "residual": list(res.residual)})


def finish_solve(solver, label: str, it: int, r: float, tol: float,
                 maxiter: int, restart: int, verbose: bool):
    """The host end of one annular solve: the solver's
    ``iterations_last_call``, the verbose line, ``check_converged``."""
    solver.iterations_last_call = it
    if verbose:
        print(f"{label} GMRES: {it} iters, resid {r:.2e}")
    check_converged(label, r, it, tol, maxiter, restart)


def converged_all(label: str, solvers, iterations, residuals, tol: float,
                  maxiter: int, restart: int):
    """The host end of a lockstep solve: each solver's
    ``iterations_last_call``, then ``check_converged`` on each system."""
    for s, it, r in zip(solvers, iterations, residuals):
        s.iterations_last_call = it
        check_converged(label, r, it, tol, maxiter, restart)


class AnnularScalarSolver:
    """(k^2 - Lap) u = f on the annulus, Robin BCs at r=lb and r=ub.

    BC convention:  la*u + lb_c*u_r = g_lb at r=lb;  ua*u + ub_c*u_r = g_ub
    at r=ub (u_r is the derivative along the generating curve's outward
    normal, i.e. d/dr of the radial coordinate).  Tensors live on ``device``.
    """

    @spanned("setup.annular")
    def __init__(self, geom: AnnularGeometry, helmholtz_k: float = 0.0,
                 la: float = 1.0, lb_c: float = 0.0,
                 ua: float = 1.0, ub_c: float = 0.0, *, device):
        self.geom = geom
        self.helmholtz_k = helmholtz_k
        self.device = torch.device(device)
        CO = geom.CO
        M, n, nk = geom.M, geom.n, geom.nk
        self.M, self.n = M, n
        row_lb = la * CO.obc_dirichlet + lb_c * CO.obc_neumann  # x=-1 <-> r=lb
        row_ub = ua * CO.ibc_dirichlet + ub_c * CO.ibc_neumann  # x=+1 <-> r=ub
        # --- per-mode preconditioner (circle approximation), host numpy -----
        apsi1 = geom.approx_psi1
        iapsi1 = 1.0 / apsi1
        iapsi2 = 1.0 / geom.approx_psi2
        D01, D12, R01, R12, R02 = CO.D01, CO.D12, CO.R01, CO.R12, CO.R02
        base_rr = iapsi2[:, None] * (D12 @ (apsi1[:, None] * D01))
        base_tt = iapsi2[:, None] * (R12 @ (iapsi1[:, None] * R01))
        k2 = helmholtz_k**2
        Kinv = np.empty((nk, M, M))
        for m in range(nk):
            K = np.empty((M, M))
            K[: M - 2] = k2 * R02 - (base_rr - (m * m) * base_tt)
            K[M - 2] = row_lb[0]
            K[M - 1] = row_ub[0]
            Kinv[m] = np.linalg.inv(K)
        dev = self._dev
        self.ops_static = dict(
            D01=dev(D01), D12=dev(D12), R01=dev(R01), R12=dev(R12),
            R02=dev(R02), row_lb=dev(row_lb), row_ub=dev(row_ub),
            tan=make_tan_plan(n, self.device), Kinv=dev(Kinv),
            helm_k2=float(k2),
        )
        self.iterations_last_call = 0

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def make_ops(self, metric: AnnularMetric) -> AnnularOps:
        """Operator bundle for this (solver, metric) pair, cached on the
        metric."""
        cache = metric.__dict__.setdefault("_annular_ops_cache", {})
        ops = cache.get(id(self))
        if ops is None:
            ops = AnnularOps(psi1=self._dev(metric.psi1),
                             inv_psi1=self._dev(metric.inv_psi1),
                             inv_psi2=self._dev(metric.inv_psi2),
                             **self.ops_static)
            cache[id(self)] = ops
        return ops

    def solve(self, metric: AnnularMetric, f, g_lb, g_ub, tol: float = 1e-12,
              maxiter: int = 200, restart: int = 40, verbose: bool = False):
        """Solve; f is (M, n), g_lb/g_ub are (n,) BC data (tensors on the
        solver's device)."""
        u, _ = self.solve_with_stats(metric, f, g_lb, g_ub, tol=tol,
                                     maxiter=maxiter, restart=restart,
                                     verbose=verbose)
        return u

    def build_rhs(self, f, g_lb, g_ub):
        """Residual-layout right-hand side: [R02 @ f ; g_lb ; g_ub]."""
        top = self.ops_static["R02"] @ f
        return torch.cat([top, g_lb[None], g_ub[None]], dim=0)

    def solve_with_stats(self, metric: AnnularMetric, f, g_lb, g_ub,
                         tol: float = 1e-12, maxiter: int = 200,
                         restart: int = 40, verbose: bool = False):
        """Like solve, also returning {'iterations', 'residual'} (0-d
        tensors on the solver's device); raises when GMRES ends with its
        true residual ||b - A u|| / ||b|| above tol.  ``iterations_last_call``
        and the check are set from the host read at the end of GMRES, so
        each replay of a planified call updates and checks them too.  That
        residual has a float64 floor of a few 1e-14 at typical sizes
        (measured 3e-14 at nb=400, M=16), so the default tol is 1e-12 where
        ipde_tpu, which never checks it, defaults to 1e-14."""
        ops = self.make_ops(metric)
        rhs = self.build_rhs(f, g_lb, g_ub)
        M, n = self.M, self.n
        res = gmres(lambda v: _matvec(ops, v, M, n), rhs.reshape(-1),
                    precond=lambda v: _precond(ops, v, M, n), tol=tol,
                    maxiter=maxiter, restart=restart)
        res.on_host(lambda it, r: finish_solve(self, "annular", it, r, tol,
                                               maxiter, restart, verbose))
        return res.x.reshape(M, n), {"iterations": res.iterations,
                                     "residual": res.residual}


class AnnularModifiedHelmholtzSolver(AnnularScalarSolver):
    """(k^2 - Lap) u = f (reference: ipde/annular/modified_helmholtz.py:90)."""

    def __init__(self, geom: AnnularGeometry, k: float, *, device, **bc):
        super().__init__(geom, helmholtz_k=k, device=device, **bc)


class AnnularPoissonSolver(AnnularScalarSolver):
    """Lap u = f (reference: ipde/annular/poisson.py:3-21); the reference
    solves (0 - Lap) u = -f, i.e. negates f; so does build_rhs, and 'solve'
    takes the PDE right-hand side of Lap u = f directly."""

    def __init__(self, geom: AnnularGeometry, *, device, **bc):
        super().__init__(geom, helmholtz_k=0.0, device=device, **bc)

    def build_rhs(self, f, g_lb, g_ub):
        return super().build_rhs(-f, g_lb, g_ub)
