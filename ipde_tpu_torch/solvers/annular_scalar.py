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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.ops.fourier import (TanPlan, make_tan_plan, tan_deriv,
                                        tan_irfft, tan_rfft)
from ipde_tpu_torch.ops.gmres import gmres


class AnnularOps(NamedTuple):
    """Operator bundle for the annular scalar solve, on one device."""
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


def _matvec(ops: AnnularOps, u_flat: torch.Tensor, M: int,
            n: int) -> torch.Tensor:
    u = u_flat.reshape(M, n)
    du = ops.D01 @ u
    term1 = ops.D12 @ (ops.psi1 * du)
    ut = tan_deriv(u, ops.tan)
    w = (ops.R01 @ ut) * ops.inv_psi1
    term2 = ops.R12 @ tan_deriv(w, ops.tan)
    lu = (term1 + term2) * ops.inv_psi2
    top = ops.helm_k2 * (ops.R02 @ u) - lu
    return torch.cat([top, ops.row_lb @ u, ops.row_ub @ u], dim=0).reshape(-1)


def _precond(ops: AnnularOps, r_flat: torch.Tensor, M: int,
             n: int) -> torch.Tensor:
    c = tan_rfft(r_flat.reshape(M, n), ops.tan)            # (M, nk)
    # out[i, k] = sum_j Kinv[k, i, j] c[j, k]: one batched product over the
    # modes, on the (re, im) pairs of c
    cr = torch.view_as_real(c).permute(1, 0, 2)             # (nk, M, 2)
    out = torch.bmm(ops.Kinv, cr).permute(1, 0, 2).contiguous()
    return tan_irfft(torch.view_as_complex(out), ops.tan).reshape(-1)


class AnnularScalarSolver:
    """(k^2 - Lap) u = f on the annulus, Robin BCs at r=lb and r=ub.

    BC convention:  la*u + lb_c*u_r = g_lb at r=lb;  ua*u + ub_c*u_r = g_ub
    at r=ub (u_r is the derivative along the generating curve's outward
    normal, i.e. d/dr of the radial coordinate).  Tensors live on ``device``.
    """

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
        """Like solve, also returning {'iterations', 'residual'}; raises
        when GMRES ends with its true residual ||b - A u|| / ||b|| above
        tol.  That residual has a float64 floor of a few 1e-14 at typical
        sizes (measured 3e-14 at nb=400, M=16), so the default tol is 1e-12
        where ipde_tpu, which never checks it, defaults to 1e-14."""
        ops = self.make_ops(metric)
        rhs = self.build_rhs(f, g_lb, g_ub)
        M, n = self.M, self.n
        res = gmres(lambda v: _matvec(ops, v, M, n), rhs.reshape(-1),
                    precond=lambda v: _precond(ops, v, M, n), tol=tol,
                    maxiter=maxiter, restart=restart)
        self.iterations_last_call = res.iterations
        if verbose:
            print(f"annular GMRES: {res.iterations} iters, "
                  f"resid {res.residual:.2e}")
        if not res.residual <= tol:
            raise RuntimeError(
                f"annular GMRES did not converge: residual "
                f"{res.residual:.3e} > tol {tol:.1e} after {res.iterations} "
                f"iterations (maxiter {maxiter}, restart {restart})")
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
