"""Right-preconditioned restarted GMRES in float64.

Replaces the reference's scipy-based ``right_gmres``
(reference: personal_utilities.scipy_gmres.right_gmres, used by
ipde/annular/modified_helmholtz.py:198).  The Krylov basis and the
operator applications stay on the vectors' device; the small Hessenberg
least-squares problem (Givens rotations, back substitution) runs on the
host, which costs one host sync per iteration.

Arnoldi uses classical Gram-Schmidt with reorthogonalization (CGS2), as in
ipde_tpu.ops.gmres.  The returned residual is the true relative residual
||b - A x|| / ||b|| of the returned x: each restart cycle ends by computing
it, and the iteration goes on while it is above tol, even where the Arnoldi
estimate had already dropped below.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class GmresResult(NamedTuple):
    x: torch.Tensor
    iterations: int            # total inner iterations performed
    residual: float            # true relative residual of x


def gmres(matvec: Callable, b: torch.Tensor,
          precond: Optional[Callable] = None, tol: float = 1e-14,
          maxiter: int = 100, restart: int = 30) -> GmresResult:
    """Solve A x = b with right-preconditioned GMRES(restart).

    matvec: x -> A x on flat vectors.  precond: r -> M^{-1} r.  At most
    ceil(maxiter / restart) restart cycles run from x = 0; convergence is
    declared when ||b - A x|| <= tol * ||b||."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    m = restart
    bnorm = float(torch.linalg.vector_norm(b))
    safe_bnorm = bnorm if bnorm > 0 else 1.0
    x = torch.zeros_like(b)
    r = b.clone()
    rnorm = float(torch.linalg.vector_norm(r))
    iters = 0
    V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    for _ in range((maxiter + m - 1) // m):
        if rnorm / safe_bnorm <= tol:
            break
        V.zero_()
        V[0] = r / rnorm
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = rnorm
        j = 0
        while j < m:
            w = matvec(precond(V[j]))
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - h1 @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            h = np.zeros(m + 1)
            h[:j + 2] = torch.cat([h1 + h2, torch.linalg.vector_norm(w)[None]]
                                  ).cpu().numpy()
            wnorm = h[j + 1]
            V[j + 1] = w / (wnorm if wnorm > 0 else 1.0)
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i] = hi
            denom = np.hypot(h[j], h[j + 1])
            cs[j], sn[j] = ((h[j] / denom, h[j + 1] / denom) if denom > 0
                            else (1.0, 0.0))
            h[j] = cs[j] * h[j] + sn[j] * h[j + 1]
            h[j + 1] = 0.0
            H[:, j] = h
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            j += 1
            if abs(g[j]) / safe_bnorm <= tol:
                break
        iters += j
        y = np.zeros(j)
        for i in range(j - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:j] @ y[i + 1:]) / H[i, i]
        yt = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        x = x + precond(yt @ V[:j])
        r = b - matvec(x)
        rnorm = float(torch.linalg.vector_norm(r))
    return GmresResult(x, iters, rnorm / safe_bnorm)
