"""Singular and smooth quadrature forms for layer potentials (host, numpy).

Spectrally accurate self-evaluation of layer potentials on smooth closed
curves via Kress-style product quadrature for periodic log-singular kernels.
These matrices are geometry-static: built once on host, then applied on
device as dense f64 matmuls.

Replaces the reference's external pybie2d singular forms
(Laplace_Layer_Singular_Form etc., SURVEY.md 2.2).

Conventions (fixed throughout the framework):
  * Laplace Green's function  G(x, y) = -log|x-y| / (2 pi)   (-lap G = delta)
  * SLP[sigma](x) = int G(x,y) sigma(y) ds_y
  * DLP[tau](x)   = int dG/dn_y (x,y) tau(y) ds_y,  n = outward normal;
    for x approaching the curve from INSIDE:  DLP -> DLP_self - tau/2
    (Gauss identity: DLP[1] = -1 inside, -1/2 principal value, 0 outside;
    verified in tests), hence the interior Dirichlet BIE is
    (DLP_self - I/2) tau = g.
  * modified Helmholtz (Yukawa) G_k(x,y) = K0(k |x-y|) / (2 pi),
    satisfying (k^2 - lap) G_k = delta.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.special import i0, i1, k0, k1

from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.utils.profiling import spanned


# ---------------------------------------------------------------------------
# Kress product quadrature for the periodic log kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def log_quad_circulant(n: int) -> np.ndarray:
    """Circulant matrix W with
        int_0^{2pi} log(4 sin^2((t-s)/2)) f(s) ds ~= sum_j W_ij f(s_j)
    exact for trigonometric polynomials of degree <= n/2.

    Fourier symbol of the kernel: m_k = -2 pi / |k| (k != 0), m_0 = 0; the
    Nyquist mode is halved (it is shared between +/- n/2).
    """
    k = np.fft.fftfreq(n, 1.0 / n)
    m = np.zeros(n)
    nz = k != 0
    m[nz] = -2.0 * np.pi / np.abs(k[nz])
    if n % 2 == 0:
        m[n // 2] *= 1.0  # rfft-style single Nyquist entry is already right
    # first column of the circulant: w_d = (1/n) sum_k m_k e^{i k d h}
    w = np.fft.ifft(m).real  # gives w[d] = (1/n) sum m_k e^{2pi i k d / n}
    i = np.arange(n)
    d = (i[:, None] - i[None, :]) % n
    return w[d]


def _pairwise(curve_s: BoundaryCurve, tx, ty):
    dx = tx[:, None] - curve_s.x[None, :]
    dy = ty[:, None] - curve_s.y[None, :]
    r2 = dx * dx + dy * dy
    return dx, dy, r2


# ---------------------------------------------------------------------------
# Laplace kernels
# ---------------------------------------------------------------------------

def laplace_slp_naive(src: BoundaryCurve, tx, ty) -> np.ndarray:
    """Plain-quadrature SLP matrix from curve nodes to targets (off-surface)."""
    _, _, r2 = _pairwise(src, np.asarray(tx).ravel(), np.asarray(ty).ravel())
    return -np.log(r2) / (4 * np.pi) * src.weights[None, :]

def laplace_dlp_naive(src: BoundaryCurve, tx, ty) -> np.ndarray:
    dx, dy, r2 = _pairwise(src, np.asarray(tx).ravel(), np.asarray(ty).ravel())
    dot = dx * src.normal_x[None, :] + dy * src.normal_y[None, :]
    return dot / (2 * np.pi * r2) * src.weights[None, :]


def laplace_slp_self(curve: BoundaryCurve) -> np.ndarray:
    """Kress spectrally-accurate SLP self-matrix."""
    n = curve.N
    dx, dy, r2 = _pairwise(curve, curve.x, curve.y)
    t = curve.t
    s2 = 4.0 * np.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    K2 = np.empty((n, n))
    off = ~np.eye(n, dtype=bool)
    K2[off] = -np.log(r2[off] / s2[off]) / (4 * np.pi)
    np.fill_diagonal(K2, -np.log(curve.speed**2) / (4 * np.pi))
    K1 = np.full((n, n), -1.0 / (4 * np.pi))
    W = log_quad_circulant(n)
    sp = curve.speed[None, :]
    return (K1 * W + K2 * curve.dt) * sp


def laplace_dlp_self(curve: BoundaryCurve) -> np.ndarray:
    """DLP self-matrix: kernel is smooth on smooth curves; diagonal limit
    (x - y).n_y / |x-y|^2 -> -kappa/2."""
    n = curve.N
    dx, dy, r2 = _pairwise(curve, curve.x, curve.y)
    K = np.empty((n, n))
    off = ~np.eye(n, dtype=bool)
    dot = dx * curve.normal_x[None, :] + dy * curve.normal_y[None, :]
    K[off] = dot[off] / (2 * np.pi * r2[off])
    np.fill_diagonal(K, -curve.curvature / (4 * np.pi))
    return K * curve.weights[None, :]


# ---------------------------------------------------------------------------
# Modified Helmholtz (Yukawa) kernels: G = K0(k r)/(2 pi)
# ---------------------------------------------------------------------------

def mh_slp_naive(src: BoundaryCurve, tx, ty, k: float) -> np.ndarray:
    _, _, r2 = _pairwise(src, np.asarray(tx).ravel(), np.asarray(ty).ravel())
    return k0(k * np.sqrt(r2)) / (2 * np.pi) * src.weights[None, :]

def mh_dlp_naive(src: BoundaryCurve, tx, ty, k: float) -> np.ndarray:
    dx, dy, r2 = _pairwise(src, np.asarray(tx).ravel(), np.asarray(ty).ravel())
    r = np.sqrt(r2)
    dot = dx * src.normal_x[None, :] + dy * src.normal_y[None, :]
    # d/dn_y K0(k|x-y|) = k K1(k r) (x-y).n_y / r
    return k * k1(k * r) * dot / (2 * np.pi * r) * src.weights[None, :]


@functools.lru_cache(maxsize=32)
def _trig_upsample_matrix(n: int, q: int) -> np.ndarray:
    """(q n, n) matrix evaluating the trig interpolant of n periodic samples
    at q n uniform nodes (Fourier zero-padding as a dense operator)."""
    modes = np.fft.rfft(np.eye(n), axis=0)
    if n % 2 == 0:
        modes[n // 2] *= 0.5  # split the Nyquist mode symmetrically
        pad = np.zeros((q * n // 2 + 1, n), dtype=complex)
        pad[: n // 2 + 1] = modes
    else:
        pad = np.zeros((q * n // 2 + 1, n), dtype=complex)
        pad[: n // 2 + 1] = modes
    return np.fft.irfft(pad, q * n, axis=0) * q


def _self_oversampling(curve: BoundaryCurve, k: float,
                       target_zh: float = 0.125, q_max: int = 12) -> int:
    """Oversampling factor so the Yukawa kernel's 1/k feature scale is
    resolved by the quadrature grid: k * max-node-spacing <= target_zh.
    Without this the 'smooth' remainder of the Kress split is underresolved
    and the self-quadrature error grows like the aliasing of K0(k r)
    (measured: 1e-14 at k h ~ 0.02, 7e-4 at k h ~ 1)."""
    zh = k * float(curve.speed.max()) * curve.dt
    return int(min(max(1, np.ceil(zh / target_zh)), q_max))


def _oversampled_self(base_builder, curve: BoundaryCurve, k: float):
    """Build a singular self matrix on a q-times-upsampled curve and
    compose with trig upsampling of the density; rows restricted to the
    original nodes (fine node j*q coincides with coarse node j)."""
    q = _self_oversampling(curve, k)
    if q == 1:
        return base_builder(curve, k)
    fine = curve.resampled(q * curve.N)
    Mf = base_builder(fine, k)
    P = _trig_upsample_matrix(curve.N, q)
    return Mf[::q, :] @ P


def _kress_band(z: np.ndarray, z_lo: float = 2.0, z_hi: float = 6.0):
    """Smooth cutoff in the scaled distance z = k r: 1 for z < z_lo, 0 for
    z > z_hi.  Restricts the Kress log-split to the near region so the
    I0(z) e^{z} growth never meets catastrophic cancellation."""
    w = np.clip((z - z_lo) / (z_hi - z_lo), 0.0, 1.0)
    # C^infinity transition via the standard exp(-1/u) partition of unity
    def f(u):
        out = np.zeros_like(u)
        pos = u > 0
        out[pos] = np.exp(-1.0 / u[pos])
        return out
    fw, f1w = f(w), f(1.0 - w)
    return f1w / (fw + f1w + 1e-300)


@spanned("setup.self_forms")
def mh_slp_self(curve: BoundaryCurve, k: float) -> np.ndarray:
    """Yukawa SLP self matrix; oversamples the quadrature grid when k h is
    large so the 1/k kernel scale stays resolved (high-k ledger parity)."""
    return _oversampled_self(_mh_slp_self_base, curve, k)


def _mh_slp_self_base(curve: BoundaryCurve, k: float) -> np.ndarray:
    """Kress quadrature for K0(k r)/(2 pi) with banded log-split.

    K0(z) = -log(z/2) I0(z) + S(z);  we write the kernel as
       A(t,s) log(4 sin^2((t-s)/2)) + B(t,s)
    with A = -I0(k r) c(z) / (4 pi)  (c = smooth band cutoff) and
    B = kernel - A log(4 sin^2).  B is smooth: near the diagonal this is the
    classical Kress split; beyond the band A = 0 and B = K0 (smooth, and
    exponentially small).
    """
    n = curve.N
    dx, dy, r2 = _pairwise(curve, curve.x, curve.y)
    r = np.sqrt(np.maximum(r2, 1e-300))
    t = curve.t
    s2 = 4.0 * np.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    z = k * r
    band = _kress_band(z)
    A = -i0(np.minimum(z, 7.0)) * band / (4 * np.pi)
    off = ~np.eye(n, dtype=bool)
    B = np.zeros((n, n))
    # off-diagonal: B = K0(z)/(2pi) - A log(4 sin^2)
    B[off] = k0(z[off]) / (2 * np.pi) - A[off] * np.log(s2[off])
    # diagonal: z -> 0:  K0 = -log(z/2) I0 + S;  log z = (1/2)[log(4 sin^2)
    #  + log(r^2 / 4 sin^2)] ->
    #  B_ii = [-log(k sp / 2) - gamma] / (2 pi)  with S(0) = -gamma I0(0)
    gamma = 0.5772156649015328606
    np.fill_diagonal(B, (-np.log(k * curve.speed / 2.0) - gamma) / (2 * np.pi))
    W = log_quad_circulant(n)
    sp = curve.speed[None, :]
    return (A * W + B * curve.dt) * sp


@spanned("setup.self_forms")
def mh_dlp_self(curve: BoundaryCurve, k: float) -> np.ndarray:
    """Yukawa DLP self matrix (oversampled at high k; see mh_slp_self)."""
    return _oversampled_self(_mh_dlp_self_base, curve, k)


def _mh_dlp_self_base(curve: BoundaryCurve, k: float) -> np.ndarray:
    """Kress quadrature for the Yukawa DLP:
       d/dn_y K0(k r)/(2 pi) = k K1(k r) (x-y).n_y / (2 pi r).
    Split via K1(z) = 1/z + log(z/2) I1(z) + T(z):
       kernel = [Laplace-DLP-like smooth part] + log-singular part with
       coefficient k I1(k r) (x-y).n_y / r."""
    n = curve.N
    dx, dy, r2 = _pairwise(curve, curve.x, curve.y)
    r = np.sqrt(np.maximum(r2, 1e-300))
    t = curve.t
    s2 = 4.0 * np.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    dot = dx * curve.normal_x[None, :] + dy * curve.normal_y[None, :]
    z = k * r
    band = _kress_band(z)
    A = k * i1(np.minimum(z, 7.0)) * band * dot / (4 * np.pi * r)
    np.fill_diagonal(A, 0.0)  # dot ~ r^2 near diagonal -> A -> 0
    off = ~np.eye(n, dtype=bool)
    B = np.zeros((n, n))
    B[off] = (k * k1(z[off]) * dot[off] / (2 * np.pi * r[off])
              - A[off] * np.log(s2[off]))
    # diagonal limit: k K1(k r) dot/r -> (1/r)(dot/r)(1/r)*... expanding:
    # K1(z) ~ 1/z  =>  kernel ~ dot / (2 pi r^2) -> -kappa/(4 pi) (Laplace);
    # the log I1 term vanishes (I1 ~ z/2, dot ~ -kappa r^2/2)
    np.fill_diagonal(B, -curve.curvature / (4 * np.pi))
    W = log_quad_circulant(n)
    return (A * W + B * curve.dt) * curve.speed[None, :]


# ---------------------------------------------------------------------------
# normal-derivative-of-SLP forms (Neumann boundary conditions)
# ---------------------------------------------------------------------------

def laplace_slp_normal_naive(src: BoundaryCurve, tx, ty, tnx, tny) -> np.ndarray:
    """d/dn_x of the Laplace SLP at off-surface targets with normals
    (tnx, tny): kernel -(x-y).n_x / (2 pi r^2)."""
    dx, dy, r2 = _pairwise(src, np.asarray(tx).ravel(), np.asarray(ty).ravel())
    dot = dx * np.asarray(tnx).ravel()[:, None] + dy * np.asarray(tny).ravel()[:, None]
    return -dot / (2 * np.pi * r2) * src.weights[None, :]


def laplace_slp_normal_self(curve: BoundaryCurve) -> np.ndarray:
    """PV of d/dn_x SLP on the curve; smooth kernel, diagonal limit
    (x-y).n_x/r^2 -> +kappa/2, so K -> -kappa/(4 pi).
    One-sided limits: interior (from inside, outward n): PV + tau/2;
    exterior: PV - tau/2 (verified in tests)."""
    n = curve.N
    dx, dy, r2 = _pairwise(curve, curve.x, curve.y)
    off = ~np.eye(n, dtype=bool)
    dot = dx * curve.normal_x[:, None] + dy * curve.normal_y[:, None]
    K = np.empty((n, n))
    K[off] = -dot[off] / (2 * np.pi * r2[off])
    np.fill_diagonal(K, -curve.curvature / (4 * np.pi))
    return K * curve.weights[None, :]


def mh_slp_normal_naive(src: BoundaryCurve, tx, ty, tnx, tny, k: float) -> np.ndarray:
    """d/dn_x of the Yukawa SLP: -k K1(k r) (x-y).n_x / (2 pi r)."""
    dx, dy, r2 = _pairwise(src, np.asarray(tx).ravel(), np.asarray(ty).ravel())
    r = np.sqrt(r2)
    dot = dx * np.asarray(tnx).ravel()[:, None] + dy * np.asarray(tny).ravel()[:, None]
    return -k * k1(k * r) * dot / (2 * np.pi * r) * src.weights[None, :]


@spanned("setup.self_forms")
def mh_slp_normal_self(curve: BoundaryCurve, k: float) -> np.ndarray:
    """PV of d/dn_x Yukawa SLP (oversampled at high k; see mh_slp_self)."""
    return _oversampled_self(_mh_slp_normal_self_base, curve, k)


def _mh_slp_normal_self_base(curve: BoundaryCurve, k: float) -> np.ndarray:
    """PV of d/dn_x of the Yukawa SLP (banded Kress split, mirroring
    mh_dlp_self with the target normal)."""
    n = curve.N
    dx, dy, r2 = _pairwise(curve, curve.x, curve.y)
    r = np.sqrt(np.maximum(r2, 1e-300))
    t = curve.t
    s2 = 4.0 * np.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    dot = dx * curve.normal_x[:, None] + dy * curve.normal_y[:, None]
    z = k * r
    band = _kress_band(z)
    A = -k * i1(np.minimum(z, 7.0)) * band * dot / (4 * np.pi * r)
    np.fill_diagonal(A, 0.0)
    off = ~np.eye(n, dtype=bool)
    B = np.zeros((n, n))
    B[off] = (-k * k1(z[off]) * dot[off] / (2 * np.pi * r[off])
              - A[off] * np.log(s2[off]))
    np.fill_diagonal(B, -curve.curvature / (4 * np.pi))
    W = log_quad_circulant(n)
    return (A * W + B * curve.dt) * curve.speed[None, :]
