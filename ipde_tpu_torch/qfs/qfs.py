"""QFS: Quadrature by Fundamental Solutions (effective-source maps).

To evaluate a layer potential accurately arbitrarily close to (or on) its
curve, replace it by an equivalent density xi on a source curve shifted to
the far side of the evaluation region, solving

    A xi = B tau      (matched on the original curve)

where B is the spectrally-accurate singular self-evaluation of the layer
potential and A the (smooth) kernel matrix from the shifted sources.  Both
maps are geometry-static dense matrices, composed on the host with LAPACK
and applied on the device as one f64 matmul.

Re-derivation of the reference's external qfs package surface
(QFS_Boundary / QFS_Evaluator / Laplace_QFS / `u2s`; SURVEY.md 2.2 and
ipde/solvers/internals/scalar.py:87-113).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.ops import singular as sq


def _reg_pinv(A: np.ndarray, rcond: float) -> np.ndarray:
    """Regularized pseudo-inverse of the exponentially ill-conditioned QFS
    system via rank-revealing pivoted QR (LAPACK gelsy), as ipde_tpu
    composes it on the host."""
    import scipy.linalg as sla
    X, _, _, _ = sla.lstsq(A, np.eye(A.shape[0]), cond=rcond,
                           lapack_driver="gelsy")
    return X


def _rule36(n: int) -> np.ndarray:
    """'Rule 36' spectral filter exp(-36 (k/kmax)^36) on the fftfreq grid
    (reference: ipde/utilities.py:126-162): ~1 below 0.8 Nyquist, ~2e-16 at
    Nyquist."""
    k = np.abs(np.fft.fftfreq(n, 1.0 / n))
    return np.exp(-36.0 * (k / k.max()) ** 36)


def _filter_rows(Bmat: np.ndarray, ncurve: int) -> np.ndarray:
    """F @ B applied spectrally per ncurve-sized component block."""
    filt = _rule36(ncurve)
    out = np.empty_like(Bmat)
    for c in range(Bmat.shape[0] // ncurve):
        blk = Bmat[c * ncurve:(c + 1) * ncurve]
        out[c * ncurve:(c + 1) * ncurve] = np.fft.ifft(
            filt[:, None] * np.fft.fft(blk, axis=0), axis=0).real
    return out


def _filter_cols(Mmat: np.ndarray, ncurve: int) -> np.ndarray:
    """M @ F per component block (F is symmetric)."""
    filt = _rule36(ncurve)
    out = np.empty_like(Mmat)
    for c in range(Mmat.shape[1] // ncurve):
        blk = Mmat[:, c * ncurve:(c + 1) * ncurve]
        out[:, c * ncurve:(c + 1) * ncurve] = np.fft.ifft(
            filt[None, :] * np.fft.fft(blk, axis=1), axis=1).real
    return out


class QFSEvaluator:
    """Maps layer densities on `curve` to an effective density on `source`.

    forms: list of (N x N) self-evaluation matrices (e.g. [SLP_self] or
    [SLP_self, DLP_self]); A: (N x N_src) kernel matrix source -> curve.
    __call__([tau_1, tau_2, ...]) returns xi with
        A xi = sum_i forms[i] tau_i.
    u2s(u) returns xi with A xi = u (values given directly on the curve).

    The composed maps are low-passed with the rule-36 filter: the pinv
    amplifies near-Nyquist input exponentially (exp(shift * k)); filtering
    the input modes the amplification acts on cuts the composed map norm
    ~100x at a field error of order the density's top-mode content, ~1e-13.
    """

    def __init__(self, source: BoundaryCurve, curve: BoundaryCurve,
                 forms: Sequence, A, rcond: float = 1e-15,
                 build_u2s: bool = True, *, device):
        """build_u2s=False skips the values->source map: it is only
        consumed by the per-boundary correction pass."""
        self.source = source
        self.curve = curve
        if (np.shape(A)[0] // curve.N) * curve.N != np.shape(A)[0]:
            raise ValueError("A must have a multiple of curve.N rows")
        Apinv = _reg_pinv(np.asarray(A), rcond)
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.mats = [dev(Apinv @ _filter_rows(np.asarray(B), curve.N))
                     for B in forms]
        self.u2s_mat = (dev(_filter_cols(Apinv, curve.N)) if build_u2s
                        else None)

    def __call__(self, densities):
        out = None
        for M, tau in zip(self.mats, densities):
            v = M @ tau
            out = v if out is None else out + v
        return out

    def u2s(self, u):
        if self.u2s_mat is None:
            raise RuntimeError("QFSEvaluator built with build_u2s=False")
        return self.u2s_mat @ u


def laplace_qfs(curve: BoundaryCurve, source: BoundaryCurve, interior: bool,
                slp: bool = True, dlp: bool = True,
                rcond: float = 1e-15, build_u2s: bool = True, *,
                device) -> QFSEvaluator:
    """Laplace QFS: effective single-layer density on `source` reproducing
    SLP/DLP of densities on `curve`, matched as the one-sided limit on the
    evaluation side (`interior`=True -> limit from inside the curve:
    DLP -> PV - tau/2; from outside: PV + tau/2)."""
    jump = -0.5 if interior else 0.5
    N = curve.N
    forms = []
    if slp:
        forms.append(sq.laplace_slp_self(curve))
    if dlp:
        forms.append(sq.laplace_dlp_self(curve) + jump * np.eye(N))
    A = sq.laplace_slp_naive(source, curve.x, curve.y)
    return QFSEvaluator(source, curve, forms, A, rcond,
                        build_u2s=build_u2s, device=device)


def mh_qfs(curve: BoundaryCurve, source: BoundaryCurve, interior: bool,
           k: float, slp: bool = True, dlp: bool = True,
           rcond: float = 1e-15, build_u2s: bool = True, *,
           device) -> QFSEvaluator:
    """Modified Helmholtz (Yukawa) QFS, as ``laplace_qfs`` with the kernel
    K0(k r) / (2 pi); the self forms oversample the curve at high k
    (ops/singular.py ``_self_oversampling``)."""
    jump = -0.5 if interior else 0.5
    N = curve.N
    forms = []
    if slp:
        forms.append(sq.mh_slp_self(curve, k))
    if dlp:
        forms.append(sq.mh_dlp_self(curve, k) + jump * np.eye(N))
    A = sq.mh_slp_naive(source, curve.x, curve.y, k)
    return QFSEvaluator(source, curve, forms, A, rcond,
                        build_u2s=build_u2s, device=device)
