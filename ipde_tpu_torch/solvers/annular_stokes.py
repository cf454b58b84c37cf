"""Spectrally accurate Stokes solver on the annular strip.

Solves  -mu lap(u) + grad p = f,  div u = 0  in the boundary-fitted annulus,
velocity (Dirichlet) BCs at both radial edges, unknowns in (r, t) components:
u = ur e_r + ut e_t, pressure on the M-1 Chebyshev grid.

Discretization as ipde_tpu.solvers.annular_stokes (the reference's
Chebyshev-tau x Fourier scheme, ipde/annular/stokes.py:75-541, in real
space): the GMRES matvec is small float64 matmuls (Chebyshev operators on the
left, tangential derivatives by torch.fft on the right) plus elementwise
metric products; the preconditioner is the exact per-Fourier-mode inverse of
the circle approximation, complex (nk, 3M-1, 3M-1) blocks inverted on the
host and applied as one batched complex128 product.

Vector-Laplacian metric terms for coordinates x = c(t) + r n(t) with
psi = s(1 + r kappa), h_r = 1, h_t = psi, and d_r psi = s kappa.

Unknown vector layout (flat): [ur (M, n) ; ut (M, n) ; p (M-1, n)].
Residual layout: [ur-eq (M-2) ; ur BCs (2) ; ut-eq (M-2) ; ut BCs (2) ;
div-eq (M-1, with the pressure-mean pin added)].

Several annuli of one (M, n) solve as one batch (``batched_stokes_solve``),
as in annular_scalar: stacked operator bundles, one lockstep GMRES.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.ops.fourier import (TanPlan, make_tan_plan, tan_deriv,
                                        tan_irfft, tan_rfft)
from ipde_tpu_torch.ops.gmres import batched_gmres, gmres
from ipde_tpu_torch.solvers.annular_scalar import (converged_all,
                                                   finish_solve,
                                                   lockstep_maps)
from ipde_tpu_torch.utils.profiling import spanned


class StokesOps(NamedTuple):
    """Operator bundle for the annular Stokes solve, on one device; in a
    batch (``stack_ops``) every tensor has a leading boundary axis and mu
    is a (B, 1, 1) tensor."""
    D01: torch.Tensor
    D12: torch.Tensor
    R01: torch.Tensor
    R12: torch.Tensor
    R02: torch.Tensor
    row_lb: torch.Tensor
    row_ub: torch.Tensor
    VI1_row0: torch.Tensor   # (1, M-1): extracts the 0th Chebyshev coeff
    alt: torch.Tensor        # (n,) +1, -1, ...: the tangential Nyquist mode
    tan: TanPlan             # last-axis rfft/derivative plan
    Kinv: torch.Tensor       # (nk, 3M-1, 3M-1) complex128
    psi0: torch.Tensor       # (M, n)
    psi1: torch.Tensor
    inv_psi1: torch.Tensor
    inv_psi2: torch.Tensor
    combo1: torch.Tensor     # 2 dr_psi / psi2^2   (M-2, n)
    combo2: torch.Tensor     # dr_psi^2 / psi2^2
    cross: torch.Tensor      # dt_curvature / (s (1+r kappa)^3)  (M-2, n)
    mu: float


def _matvec(ops: StokesOps, v: torch.Tensor, M: int, n: int) -> torch.Tensor:
    """A v for flat v of shape ((3M-1) n,), or (B, (3M-1) n) with batched
    ops."""
    NU = M * n
    lead = v.shape[:-1]
    ur = v[..., :NU].reshape(*lead, M, n)
    ut = v[..., NU:2 * NU].reshape(*lead, M, n)
    p = v[..., 2 * NU:].reshape(*lead, M - 1, n)
    # one batched transform for the (ur, ut, p) tangential derivatives
    d_all = tan_deriv(torch.cat([ur, ut, p], dim=-2), ops.tan)
    dur = d_all[..., :M, :]
    dut = d_all[..., M:2 * M, :]
    dp = d_all[..., 2 * M:, :]
    # one batched transform for the two Laplacian inner derivatives
    w_r = (ops.R01 @ dur) * ops.inv_psi1
    w_t = (ops.R01 @ dut) * ops.inv_psi1
    dw = tan_deriv(torch.cat([w_r, w_t], dim=-2), ops.tan)
    Mm1 = M - 1

    def scalar_lap(u, dwk):
        t1 = ops.D12 @ (ops.psi1 * (ops.D01 @ u))
        t2 = ops.R12 @ dwk
        return (t1 + t2) * ops.inv_psi2

    lap_ur = scalar_lap(ur, dw[..., :Mm1, :])
    lap_ut = scalar_lap(ut, dw[..., Mm1:, :])
    W1r = ops.R02 @ ur
    W1t = ops.R02 @ ut
    fr = (ops.mu * (-lap_ur + (ops.R02 @ dut) * ops.combo1
                    + W1r * ops.combo2 + W1t * ops.cross)
          + ops.D12 @ p)
    ft = (ops.mu * (-lap_ut - (ops.R02 @ dur) * ops.combo1
                    + W1t * ops.combo2 - W1r * ops.cross)
          + (ops.R12 @ dp) * ops.inv_psi2)
    fp = (ops.D01 @ (ur * ops.psi0) + ops.R01 @ dut) * ops.inv_psi1
    # pressure pins: the mean (mode 0) and the tangential Nyquist mode of
    # the constant-in-r pressure are invisible to D12/Dt (Dt zeroes the
    # Nyquist derivative); pin both so the system is nonsingular
    mean = lambda a: a.mean(dim=(-2, -1), keepdim=True)  # noqa: E731
    fp = fp + mean(ops.VI1_row0 @ p)
    fp = fp + mean(ops.VI1_row0 @ (p * ops.alt)) * ops.alt
    return torch.cat([a.reshape(*lead, -1) for a in (
        fr, ops.row_lb @ ur, ops.row_ub @ ur, ft, ops.row_lb @ ut,
        ops.row_ub @ ut, fp)], dim=-1)


def _precond(ops: StokesOps, v: torch.Tensor, M: int,
             n: int) -> torch.Tensor:
    """The per-mode preconditioner on flat v, unbatched or (B, ...)."""
    c = tan_rfft(v.reshape(*v.shape[:-1], 3 * M - 1, n), ops.tan)
    # out[i, k] = sum_j Kinv[k, i, j] c[j, k]: one batched complex product
    out = torch.matmul(ops.Kinv, c.transpose(-2, -1)[..., None])[..., 0]
    return tan_irfft(out.transpose(-2, -1), ops.tan).reshape(v.shape)


def batched_stokes_solve(solvers, metrics, rhss, tol: float = 1e-12,
                         maxiter: int = 200, restart: int = 50, mesh=None):
    """Solve B same-shape annular Stokes problems in one lockstep GMRES.

    rhss: flat right-hand sides from AnnularStokesSolver.build_rhs.  With a
    ``mesh`` the boundary axis is split over its devices, as in
    ``batched_annular_solve``.  Returns (list of (ur, ut, p_full) triples,
    {'iterations': [B 0-d tensors], 'residual': [B 0-d tensors]}); raises
    as ``solve_with_stats`` does."""
    M, n = solvers[0].M, solvers[0].n
    b = torch.stack(rhss)
    mv, pc = lockstep_maps([s.make_ops(m) for s, m in zip(solvers, metrics)],
                           mesh, (lambda o, v: _matvec(o, v, M, n),
                                  lambda o, v: _precond(o, v, M, n)),
                           b.device)
    res = batched_gmres(mv, b, precond=pc, tol=tol, maxiter=maxiter,
                        restart=restart)
    res.on_host(lambda its, rs: converged_all(
        "annular Stokes", solvers, its, rs, tol, maxiter, restart))
    return ([s.split(x) for s, x in zip(solvers, res.x)],
            {"iterations": list(res.iterations),
             "residual": list(res.residual)})


class AnnularStokesSolver:
    """Velocity-Dirichlet Stokes solve on the annulus, (r, t) components.

    solve(metric, fr, ft, lbc_r, lbc_t, ubc_r, ubc_t) -> (ur, ut, p) with p
    prolonged to the M-node radial grid.  Tensors live on ``device``.  The
    float32 / mixed-precision preconditioner paths of ipde_tpu are not
    ported (float64 is native on the GPU).
    """

    @spanned("setup.annular")
    def __init__(self, geom: AnnularGeometry, mu: float = 1.0, *, device):
        self.geom = geom
        self.mu = float(mu)
        self.device = torch.device(device)
        CO = geom.CO
        M, n, nk = geom.M, geom.n, geom.nk
        self.M, self.n = M, n
        D01, D12 = CO.D01, CO.D12
        R01, R12, R02 = CO.R01, CO.R12, CO.R02
        lbc, ubc = CO.obc_dirichlet, CO.ibc_dirichlet  # x=-1 <-> lb
        apsi0 = geom.approx_psi0
        apsi1 = geom.approx_psi1
        iapsi1 = 1.0 / apsi1
        iapsi2 = 1.0 / geom.approx_psi2
        # circle approximation: psi = r (radius), d_r psi = 1, kappa' = 0
        base_rr = iapsi2[:, None] * (D12 @ (apsi1[:, None] * D01))
        base_tt = iapsi2[:, None] * (R12 @ (iapsi1[:, None] * R01))
        c1 = 2.0 / geom.approx_psi2**2      # combo1 on circle (dr_psi = 1)
        c2 = 1.0 / geom.approx_psi2**2      # combo2 on circle
        Kinv = np.empty((nk, 3 * M - 1, 3 * M - 1), dtype=complex)
        for m in range(nk):
            LL = base_rr - (m * m) * base_tt
            K = np.zeros((3 * M - 1, 3 * M - 1), dtype=complex)
            im = 1j * m
            # ur rows
            K[0:M - 2, 0:M] = self.mu * (-LL + c2[:, None] * R02)
            K[0:M - 2, M:2 * M] = self.mu * (c1[:, None] * R02 * im)
            K[0:M - 2, 2 * M:] = D12
            K[M - 2, 0:M] = lbc[0]
            K[M - 1, 0:M] = ubc[0]
            # ut rows
            K[M:2 * M - 2, 0:M] = -self.mu * (c1[:, None] * R02 * im)
            K[M:2 * M - 2, M:2 * M] = self.mu * (-LL + c2[:, None] * R02)
            K[M:2 * M - 2, 2 * M:] = iapsi2[:, None] * R12 * im
            K[2 * M - 2, M:2 * M] = lbc[0]
            K[2 * M - 1, M:2 * M] = ubc[0]
            # div rows
            K[2 * M:, 0:M] = iapsi1[:, None] * (D01 @ np.diag(apsi0))
            K[2 * M:, M:2 * M] = iapsi1[:, None] * R01 * im
            if m == 0 or (n % 2 == 0 and m == nk - 1):
                K[2 * M:, 2 * M:] += CO.VI1[0][None, :]
            if n % 2 == 0 and m == nk - 1:
                # the matvec's Dt zeroes the Nyquist derivative: build the
                # preconditioner block consistently (no m-coupling terms)
                K[0:M - 2, M:2 * M] = 0.0
                K[M:2 * M - 2, 0:M] = 0.0
                K[M:2 * M - 2, 2 * M:] = 0.0
                K[2 * M:, M:2 * M] = 0.0
                LL0 = base_rr
                K[0:M - 2, 0:M] = self.mu * (-LL0 + c2[:, None] * R02)
                K[M:2 * M - 2, M:2 * M] = self.mu * (-LL0 + c2[:, None] * R02)
            Kinv[m] = np.linalg.inv(K)
        dev = self._dev
        self._static = dict(
            D01=dev(D01), D12=dev(D12), R01=dev(R01), R12=dev(R12),
            R02=dev(R02), row_lb=dev(lbc), row_ub=dev(ubc),
            VI1_row0=dev(CO.VI1[:1]),
            alt=dev(1.0 - 2.0 * (np.arange(n) % 2)),
            tan=make_tan_plan(n, self.device),
            Kinv=torch.as_tensor(Kinv, dtype=torch.complex128,
                                 device=self.device),
            mu=self.mu,
        )
        self.P10 = dev(CO.P10)
        self.iterations_last_call = 0

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def make_ops(self, metric: AnnularMetric) -> StokesOps:
        """Operator bundle for this (solver, metric) pair, cached on the
        metric."""
        cache = metric.__dict__.setdefault("_stokes_ops_cache", {})
        ops = cache.get(id(self))
        if ops is not None:
            return ops
        dr_psi = metric.speed * metric.curvature   # (n,)
        ipsi2sq = metric.inv_psi2**2               # (M-2, n)
        cross = (metric.dt_curvature
                 / (metric.speed * (1.0 + self.geom.rv2[:, None]
                                    * metric.curvature) ** 3))
        dev = self._dev
        ops = StokesOps(psi0=dev(metric.psi0), psi1=dev(metric.psi1),
                        inv_psi1=dev(metric.inv_psi1),
                        inv_psi2=dev(metric.inv_psi2),
                        combo1=dev(2.0 * dr_psi * ipsi2sq),
                        combo2=dev(dr_psi**2 * ipsi2sq), cross=dev(cross),
                        **self._static)
        cache[id(self)] = ops
        return ops

    def solve(self, metric: AnnularMetric, fr, ft, lbc_r, lbc_t, ubc_r,
              ubc_t, tol: float = 1e-12, maxiter: int = 200,
              restart: int = 50, verbose: bool = False):
        (ur, ut, p_full), _ = self.solve_with_stats(
            metric, fr, ft, lbc_r, lbc_t, ubc_r, ubc_t, tol=tol,
            maxiter=maxiter, restart=restart, verbose=verbose)
        return ur, ut, p_full

    def build_rhs(self, fr, ft, lbc_r, lbc_t, ubc_r, ubc_t):
        """Flat right-hand side in the residual layout."""
        R02 = self._static["R02"]
        return torch.cat([
            (R02 @ fr).reshape(-1), lbc_r, ubc_r,
            (R02 @ ft).reshape(-1), lbc_t, ubc_t,
            fr.new_zeros((self.M - 1) * self.n),
        ])

    def solve_with_stats(self, metric: AnnularMetric, fr, ft, lbc_r, lbc_t,
                         ubc_r, ubc_t, tol: float = 1e-12, maxiter: int = 200,
                         restart: int = 50, verbose: bool = False):
        """Like solve, also returning {'iterations', 'residual'}; raises
        when GMRES ends with its true residual ||b - A x|| / ||b|| above
        tol (see AnnularScalarSolver.solve_with_stats for the default)."""
        ops = self.make_ops(metric)
        rhs = self.build_rhs(fr, ft, lbc_r, lbc_t, ubc_r, ubc_t)
        M, n = self.M, self.n
        res = gmres(lambda v: _matvec(ops, v, M, n), rhs,
                    precond=lambda v: _precond(ops, v, M, n), tol=tol,
                    maxiter=maxiter, restart=restart)
        res.on_host(lambda it, r: finish_solve(
            self, "annular Stokes", it, r, tol, maxiter, restart, verbose))
        return self.split(res.x), {"iterations": res.iterations,
                                   "residual": res.residual}

    def split(self, x):
        """(ur, ut, p_full) of a flat solution, p prolonged to M nodes."""
        M, n = self.M, self.n
        NU = M * n
        p_full = self.P10 @ x[2 * NU:].reshape(M - 1, n)
        return x[:NU].reshape(M, n), x[NU:2 * NU].reshape(M, n), p_full
