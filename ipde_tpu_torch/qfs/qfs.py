"""QFS: Quadrature by Fundamental Solutions (effective-source maps).

To evaluate a layer potential accurately arbitrarily close to (or on) its
curve, replace it by an equivalent density xi on a source curve shifted to
the far side of the evaluation region, solving

    A xi = B tau      (matched on the original curve)

where B is the spectrally-accurate singular self-evaluation of the layer
potential and A the (smooth) kernel matrix from the shifted sources.  Both
maps are geometry-static dense matrices applied on the device as one f64
matmul.  Two backends build them, as in ipde_tpu: ``"host"`` forms them with
numpy and composes them with LAPACK (gelsy), then uploads; ``"device"``
forms them on the device (ops/forms_dev.py) and composes them there by a
min-norm CholeskyQR2 (``_minnorm_compose``).  ``auto_backend`` picks one by
the device and the system size.

Re-derivation of the reference's external qfs package surface
(QFS_Boundary / QFS_Evaluator / Laplace_QFS / `u2s`; SURVEY.md 2.2 and
ipde/solvers/internals/scalar.py:87-113).
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
import torch

from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.ops import forms_dev as fd
from ipde_tpu_torch.ops import singular as sq
from ipde_tpu_torch.utils.profiling import spanned

# the boundary size from which auto_backend builds the QFS and BIE systems
# on a CUDA device (IPDE_QFS_DEVICE_MIN overrides it): the smallest size
# measured with tools/torch_profile_setup.py on an H100 (PERF.md section
# 5), where the device setup already took half the host's time or less;
# nothing smaller was measured
DEVICE_MIN = 32


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


@functools.lru_cache(maxsize=16)
def resample_dev(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) exact trigonometric-interpolation matrix for periodic
    uniform grids (spectral upsampling) on ``device``: built on the host with
    numpy's FFT, uploaded once per (n_in, n_out, device) and shared by every
    QFS map between curves of those sizes."""
    F = np.fft.fft(np.eye(n_in), axis=0)
    rows = np.mod(np.fft.fftfreq(n_in, 1.0 / n_in).round().astype(int),
                  n_out)
    Fp = np.zeros((n_out, n_in), np.complex128)
    Fp[rows] = F
    # .real of the (one-sided-Nyquist) inverse = the usual split-Nyquist
    # hermitian symmetrization
    return torch.as_tensor(np.fft.ifft(Fp, axis=0).real * (n_out / n_in),
                           device=device)


def _cholesky_shifted(G: torch.Tensor):
    """Cholesky factor of the Gram matrix G with ipde_tpu's shifted retries
    (shifted CholeskyQR: jitter by multiples of u |G|; the later passes
    remove the shift's effect on Q).  Returns (L, number of shifted
    retries).  Raises torch.linalg.LinAlgError when G is still not positive
    definite after five shifts."""
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    shift = 0.0
    for retries in range(6):
        L, info = torch.linalg.cholesky_ex(G)
        if int(info) == 0 and bool(torch.isfinite(L.diagonal()).all()):
            return L, retries
        shift = (shift or 1e-13 * float(torch.trace(G)) / G.shape[0]) * 100.0
        G = G + shift * eye
    raise torch.linalg.LinAlgError(
        "QFS compose: the Gram matrix is not positive definite after five "
        "shifted retries")


def _minnorm_compose(A: torch.Tensor, forms: Sequence, refine: int = 2):
    """Maps M_i = A^+ F_i for a full-row-rank system A (m, n), m <= n, by a
    min-norm CholeskyQR2 (ipde_tpu.ops.device_linalg.minnorm_compose, in
    native FP64 with cuSOLVER's Cholesky and triangular solves).

    With A^T = Q R (Q n x m orthonormal columns), A^+ = Q R^{-T}.
    CholeskyQR takes R^T from the Cholesky factor L1 of G = A A^T and
    Q^T = L1^{-1} A; a second pass on Q^T re-orthonormalizes it (CholeskyQR2),
    which makes the factorization backward stable while cond(G) u < 1; a
    third pass follows when the second needed a shifted retry (shifted
    CholeskyQR3).  The explicit pseudo-inverse E = Q (L1 L2 ..)^{-1} is
    formed once; each map is E F_i plus ``refine`` residual-correction
    passes M += E (F_i - A M).  Returns (maps, shifted retries)."""
    m = A.shape[0]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    L, retries = _cholesky_shifted(A @ A.T)
    factors = [L]
    QT = torch.linalg.solve_triangular(L, A, upper=False)
    L, shifted = _cholesky_shifted(QT @ QT.T)
    factors.append(L)
    QT = torch.linalg.solve_triangular(L, QT, upper=False)
    retries += shifted
    if shifted:
        L, more = _cholesky_shifted(QT @ QT.T)
        factors.append(L)
        QT = torch.linalg.solve_triangular(L, QT, upper=False)
        retries += more
    X = eye
    for L in factors:
        X = torch.linalg.solve_triangular(L, X, upper=False)
    E = QT.T @ X
    maps = []
    for B in forms:
        M = E @ B
        for _ in range(refine):
            M = M + E @ (B - A @ M)
        maps.append(M)
    return maps, retries


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

    backend ``"host"``: numpy forms and A, LAPACK gelsy pseudo-inverse, the
    maps uploaded to ``device``.  backend ``"device"``: forms and A are
    tensors on ``device`` (ops/forms_dev.py), filtered there and composed by
    ``_minnorm_compose``; ``shifted_retries`` counts its shifted Cholesky
    retries.  Band-limited source compression (device backend, as in
    ipde_tpu): the source curve is upsampled (N_src = u N) for quadrature
    accuracy, but the effective density it carries is band-limited to the
    filtered input band, so the min-norm solve runs in an N-point
    coefficient space eta with xi = U eta (U = ``resample_dev``), and every
    stored map is (c N, c N) instead of (c N_src, c N); ``__call__`` and
    ``u2s`` return the pointwise xi either way.
    """

    @spanned("setup.qfs")
    def __init__(self, source: BoundaryCurve, curve: BoundaryCurve,
                 forms: Sequence, A, rcond: float = 1e-15,
                 build_u2s: bool = True, backend: str = "host", *, device):
        """build_u2s=False skips the values->source map: it is only
        consumed by the per-boundary correction pass."""
        self.source = source
        self.curve = curve
        self.up = None
        self.shifted_retries = 0
        if (np.shape(A)[0] // curve.N) * curve.N != np.shape(A)[0]:
            raise ValueError("A must have a multiple of curve.N rows")
        self._ncomp = np.shape(A)[1] // source.N
        if backend == "device":
            S, N = source.N, curve.N
            if S > N:
                self.up = resample_dev(N, S, device)
                A = torch.cat([A[:, c * S:(c + 1) * S] @ self.up
                               for c in range(self._ncomp)], dim=1)
            comps = [fd.filter_rows_dev(B, N) for B in forms]
            if build_u2s:
                comps.append(fd.filter_cols_dev(
                    torch.eye(A.shape[0], dtype=A.dtype, device=A.device), N))
            maps, self.shifted_retries = _minnorm_compose(A, comps)
            self.u2s_mat = maps.pop() if build_u2s else None
            self.mats = maps
            return
        if backend != "host":
            raise ValueError(f"unknown QFS backend {backend!r}")
        Apinv = _reg_pinv(np.asarray(A), rcond)
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.mats = [dev(Apinv @ _filter_rows(np.asarray(B), curve.N))
                     for B in forms]
        self.u2s_mat = (dev(_filter_cols(Apinv, curve.N)) if build_u2s
                        else None)

    def _upsample(self, eta):
        """The coefficient-space density eta (ncomp N,) or (ncomp N, B) ->
        xi (ncomp N_src,) or (ncomp N_src, B) pointwise on the source curve
        (identity when the maps are full-size)."""
        if self.up is None:
            return eta
        xi = self.up @ eta.reshape(self._ncomp, self.curve.N, -1)
        return xi.reshape(-1, *eta.shape[1:])

    def __call__(self, densities):
        out = None
        for M, tau in zip(self.mats, densities):
            v = M @ tau
            out = v if out is None else out + v
        return self._upsample(out)

    def u2s(self, u):
        if self.u2s_mat is None:
            raise RuntimeError("QFSEvaluator built with build_u2s=False")
        return self._upsample(self.u2s_mat @ u)


def auto_backend(n: int, device) -> str:
    """The setup backend of a QFS map or BIE with characteristic size ``n``
    (boundary points) on ``device``: ``"host"`` on the CPU, and on a CUDA
    device ``"device"`` from ``n >= DEVICE_MIN`` (``IPDE_QFS_DEVICE_MIN``
    overrides the threshold).  ``IPDE_QFS_BACKEND=host|device`` overrides
    the choice."""
    env = os.environ.get("IPDE_QFS_BACKEND")
    if env:
        if env not in ("host", "device"):
            raise ValueError(f"IPDE_QFS_BACKEND={env!r}: host or device")
        return env
    if torch.device(device).type != "cuda":
        return "host"
    n_min = int(os.environ.get("IPDE_QFS_DEVICE_MIN", DEVICE_MIN))
    return "device" if n >= n_min else "host"


@spanned("setup.qfs")
def laplace_qfs(curve: BoundaryCurve, source: BoundaryCurve, interior: bool,
                slp: bool = True, dlp: bool = True,
                rcond: float = 1e-15, build_u2s: bool = True,
                backend: str = None, *, device) -> QFSEvaluator:
    """Laplace QFS: effective single-layer density on `source` reproducing
    SLP/DLP of densities on `curve`, matched as the one-sided limit on the
    evaluation side (`interior`=True -> limit from inside the curve:
    DLP -> PV - tau/2; from outside: PV + tau/2).  backend None:
    ``auto_backend(curve.N, device)``."""
    backend = backend or auto_backend(curve.N, device)
    b = fd.FormBuilders(backend, device)
    jump = -0.5 if interior else 0.5
    forms = []
    if slp:
        forms.append(b.form("laplace_slp_self")(curve))
    if dlp:
        forms.append(b.form("laplace_dlp_self")(curve) + jump * b.eye(curve.N))
    A = b.form("laplace_slp_naive")(source, curve.x, curve.y)
    return QFSEvaluator(source, curve, forms, A, rcond, build_u2s=build_u2s,
                        backend=backend, device=device)


@spanned("setup.qfs")
def mh_qfs(curve: BoundaryCurve, source: BoundaryCurve, interior: bool,
           k: float, slp: bool = True, dlp: bool = True,
           rcond: float = 1e-15, build_u2s: bool = True,
           backend: str = None, *, device) -> QFSEvaluator:
    """Modified Helmholtz (Yukawa) QFS, as ``laplace_qfs`` with the kernel
    K0(k r) / (2 pi); the self forms oversample the curve at high k
    (ops/singular.py ``_self_oversampling``) and stay host-built on either
    backend (uploaded for ``"device"``, as in ipde_tpu): they are (N, N),
    small next to the (N, N_src) system, which the device backend forms on
    the device."""
    backend = backend or auto_backend(curve.N, device)
    b = fd.FormBuilders(backend, device)
    jump = -0.5 if interior else 0.5
    forms = []
    if slp:
        forms.append(b.lift(sq.mh_slp_self(curve, k)))
    if dlp:
        forms.append(b.lift(sq.mh_dlp_self(curve, k)) + jump * b.eye(curve.N))
    A = b.form("mh_slp_naive")(source, curve.x, curve.y, k)
    return QFSEvaluator(source, curve, forms, A, rcond, build_u2s=build_u2s,
                        backend=backend, device=device)
