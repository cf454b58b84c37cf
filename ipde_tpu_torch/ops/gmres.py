"""Right-preconditioned restarted GMRES in float64, for one system or for B
independent systems in lockstep.

Replaces the reference's scipy-based ``right_gmres``
(reference: personal_utilities.scipy_gmres.right_gmres, used by
ipde/annular/modified_helmholtz.py:198).  The Krylov basis and the
operator applications stay on the vectors' device; the small Hessenberg
least-squares problems (Givens rotations, back substitution) run on the
host, which costs one host sync per iteration: for all B systems at once
in ``batched_gmres`` (their B Hessenberg columns come over in one copy).

Arnoldi uses classical Gram-Schmidt with reorthogonalization (CGS2), as in
ipde_tpu.ops.gmres.  The returned residual is the true relative residual
||b - A x|| / ||b|| of the returned x: each restart cycle ends by computing
it, and the iteration goes on while it is above tol, even where the Arnoldi
estimate had already dropped below.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


class GmresResult(NamedTuple):
    x: torch.Tensor
    iterations: int            # total inner iterations performed
    residual: float            # true relative residual of x


class BatchedGmresResult(NamedTuple):
    x: torch.Tensor            # (B, N)
    iterations: List[int]      # per system
    residual: List[float]      # per system: true relative residual of x[b]


def gmres(matvec: Callable, b: torch.Tensor,
          precond: Optional[Callable] = None, tol: float = 1e-14,
          maxiter: int = 100, restart: int = 30) -> GmresResult:
    """Solve A x = b with right-preconditioned GMRES(restart).

    matvec: x -> A x on flat vectors.  precond: r -> M^{-1} r.  At most
    ceil(maxiter / restart) restart cycles run from x = 0; convergence is
    declared when ||b - A x|| <= tol * ||b||."""
    pc = (lambda v: v) if precond is None else \
        (lambda v: precond(v[0])[None])  # noqa: E731
    res = batched_gmres(lambda v: matvec(v[0])[None], b[None], pc, tol=tol,
                        maxiter=maxiter, restart=restart)
    return GmresResult(res.x[0], res.iterations[0], res.residual[0])


def batched_gmres(matvec: Callable, b: torch.Tensor,
                  precond: Optional[Callable] = None, tol: float = 1e-14,
                  maxiter: int = 100, restart: int = 30) -> BatchedGmresResult:
    """Solve the B independent systems A_i x_i = b_i (b: (B, N)) with
    right-preconditioned GMRES(restart) in lockstep.

    matvec and precond map a (B, N) stack to a (B, N) stack, row i through
    A_i and M_i^{-1}; both must be linear (a zero row gives a zero row).
    Each system follows the iteration ``gmres`` runs on it alone: the
    restart cycles are shared, a system that meets tol inside a cycle is fed
    zero rows until the cycle ends, and a system whose true residual has met
    tol at the end of a cycle is frozen."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    B = b.shape[0]
    m = restart
    dev = b.device
    bnorm = torch.linalg.vector_norm(b, dim=1).cpu().numpy()
    safe_bnorm = np.where(bnorm > 0, bnorm, 1.0)
    x = torch.zeros_like(b)
    r = b.clone()
    rnorm = bnorm.copy()
    iters = np.zeros(B, dtype=np.int64)
    V = b.new_zeros((B, m + 1, b.shape[1]))
    for _ in range((maxiter + m - 1) // m):
        run = ~(rnorm / safe_bnorm <= tol)
        if not run.any():
            break
        V.zero_()
        # a system outside this cycle gets a zero basis (r / inf)
        V[:, 0] = r / torch.as_tensor(np.where(run, rnorm, np.inf),
                                      device=dev)[:, None]
        H = np.zeros((B, m + 1, m))
        cs = np.zeros((B, m))
        sn = np.zeros((B, m))
        g = np.zeros((B, m + 1))
        g[:, 0] = np.where(run, rnorm, 0.0)
        live = run.copy()
        steps = np.zeros(B, dtype=np.int64)
        fed = live.copy()
        feed = torch.as_tensor(fed, dtype=b.dtype, device=dev)[:, None]
        j = 0
        while j < m and live.any():
            w = matvec(precond(V[:, j] * feed))
            Vj = V[:, :j + 1]
            h1 = torch.bmm(Vj, w[:, :, None])[:, :, 0]
            w = w - torch.bmm(h1[:, None], Vj)[:, 0]
            h2 = torch.bmm(Vj, w[:, :, None])[:, :, 0]
            w = w - torch.bmm(h2[:, None], Vj)[:, 0]
            wnorm = torch.linalg.vector_norm(w, dim=1)
            cols = torch.cat([h1 + h2, wnorm[:, None]], dim=1).cpu().numpy()
            V[:, j + 1] = w / torch.where(wnorm > 0, wnorm, 1.0)[:, None]
            for s in np.flatnonzero(live):
                h = np.zeros(m + 1)
                h[:j + 2] = cols[s]
                for i in range(j):
                    hi = cs[s, i] * h[i] + sn[s, i] * h[i + 1]
                    h[i + 1] = -sn[s, i] * h[i] + cs[s, i] * h[i + 1]
                    h[i] = hi
                denom = np.hypot(h[j], h[j + 1])
                cs[s, j], sn[s, j] = ((h[j] / denom, h[j + 1] / denom)
                                      if denom > 0 else (1.0, 0.0))
                h[j] = cs[s, j] * h[j] + sn[s, j] * h[j + 1]
                h[j + 1] = 0.0
                H[s, :, j] = h
                g[s, j + 1] = -sn[s, j] * g[s, j]
                g[s, j] = cs[s, j] * g[s, j]
                steps[s] = j + 1
                if abs(g[s, j + 1]) / safe_bnorm[s] <= tol:
                    live[s] = False
            j += 1
            if live.any() and (live != fed).any():
                fed = live.copy()
                feed = torch.as_tensor(fed, dtype=b.dtype,
                                       device=dev)[:, None]
        iters += steps
        Y = np.zeros((B, m))
        for s in np.flatnonzero(run):
            k = steps[s]
            for i in range(k - 1, -1, -1):
                Y[s, i] = (g[s, i] - H[s, i, i + 1:k] @ Y[s, i + 1:k]) \
                    / H[s, i, i]
        Yt = torch.as_tensor(Y, dtype=b.dtype, device=dev)
        x = x + precond(torch.bmm(Yt[:, None], V[:, :m])[:, 0])
        r = b - matvec(x)
        rnorm = np.where(run, torch.linalg.vector_norm(r, dim=1).cpu().numpy(),
                         rnorm)
    return BatchedGmresResult(x, [int(i) for i in iters],
                              [float(v) for v in rnorm / safe_bnorm])
