"""Stokes layer-potential kernels: naive forms, Kress self-forms, and the
dense Stokeslet apply (mu = 1 throughout; reference surface: pybie2d
Stokes_Layer_* rows in SURVEY.md 2.2).

Conventions (as in ipde_tpu.ops.stokes_kernels):
  Stokeslet (SLP) velocity: G_ij = (1/4pi)(-delta_ij log r + r_i r_j / r^2)
  Stokeslet pressure:       P_j  = r_j / (2 pi r^2)
  Stresslet (DLP) velocity: K_ij = (1/pi) r_i r_j (r.n_y) / r^4
  Stresslet pressure:       Q_j  = (1/pi) (-n_j / r^2 + 2 r_j (r.n_y) / r^4)
with r = x - y (target minus source), n_y the source outward normal.

Interior Green representation (Lorentz):  for a Stokes solution (u, p) inside
a closed curve with traction t = sigma.n on it (outward n),
    u(x) = SLP[t](x) - DLP[u](x)           x inside
    p(x) = SLPp[t](x) - DLPp[u](x)
with one-sided limits DLP -> PV - u/2 (inside), PV + u/2 (outside).

Vector densities are packed [fx (N,) ; fy (N,)] -> matrices are (2T, 2S).
The host forms are numpy; ``stokes_slp_apply`` runs on tensors: on a CUDA
tensor in the hand-written FP64 kernel ``csrc/stokes_slp.cu``, on a CPU
tensor in the plain torch version beside it.  The wrapper never falls back:
a CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.ops.kernels import (_MIN_R2, _PLAIN_CHUNK_ELEMS,
                                        _launch, build_library,
                                        check_f64_1d, device_table,
                                        split_scratch)
from ipde_tpu_torch.ops.singular import log_quad_circulant


def _geom(src: BoundaryCurve, tx, ty):
    dx = np.asarray(tx).ravel()[:, None] - src.x[None, :]
    dy = np.asarray(ty).ravel()[:, None] - src.y[None, :]
    r2 = dx * dx + dy * dy
    return dx, dy, r2


def _block(axx, axy, ayx, ayy):
    return np.block([[axx, axy], [ayx, ayy]])


# ---------------------------------------------------------------------------
# naive (smooth-quadrature) forms
# ---------------------------------------------------------------------------

def stokes_slp_naive(src: BoundaryCurve, tx, ty) -> np.ndarray:
    """(2T, 2S) velocity matrix of the single layer."""
    dx, dy, r2 = _geom(src, tx, ty)
    ilr = -0.5 * np.log(r2)
    ir2 = 1.0 / r2
    w = src.weights[None, :] / (4 * np.pi)
    return _block((ilr + dx * dx * ir2) * w, (dx * dy * ir2) * w,
                  (dx * dy * ir2) * w, (ilr + dy * dy * ir2) * w)


def stokes_slp_pressure_naive(src: BoundaryCurve, tx, ty) -> np.ndarray:
    """(T, 2S) pressure matrix of the single layer."""
    dx, dy, r2 = _geom(src, tx, ty)
    w = src.weights[None, :] / (2 * np.pi)
    return np.hstack([dx / r2 * w, dy / r2 * w])


def stokes_dlp_naive(src: BoundaryCurve, tx, ty) -> np.ndarray:
    """(2T, 2S) velocity matrix of the double layer (stresslet)."""
    dx, dy, r2 = _geom(src, tx, ty)
    rn = dx * src.normal_x[None, :] + dy * src.normal_y[None, :]
    c = rn / (r2 * r2) * (src.weights[None, :] / np.pi)
    return _block(c * dx * dx, c * dx * dy, c * dy * dx, c * dy * dy)


def stokes_dlp_pressure_naive(src: BoundaryCurve, tx, ty) -> np.ndarray:
    """(T, 2S) pressure matrix of the double layer."""
    dx, dy, r2 = _geom(src, tx, ty)
    rn = dx * src.normal_x[None, :] + dy * src.normal_y[None, :]
    w = src.weights[None, :] / np.pi
    px = (-src.normal_x[None, :] / r2 + 2 * dx * rn / r2**2) * w
    py = (-src.normal_y[None, :] / r2 + 2 * dy * rn / r2**2) * w
    return np.hstack([px, py])


# ---------------------------------------------------------------------------
# Kress self-evaluation forms
# ---------------------------------------------------------------------------

def stokes_slp_self(curve: BoundaryCurve) -> np.ndarray:
    """(2N, 2N) spectrally accurate on-surface SLP velocity matrix."""
    n = curve.N
    dx, dy, r2 = _geom(curve, curve.x, curve.y)
    t = curve.t
    s2 = 4.0 * np.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    off = ~np.eye(n, dtype=bool)
    # log part: coefficient -delta_ij/(8 pi) (since -log r = -(1/2) log r^2)
    W = log_quad_circulant(n)
    logA = -W / (8 * np.pi)
    # smooth remainders
    Sd = np.empty((n, n))       # the -(1/2) log(r^2/4sin^2) delta part
    Sd[off] = -0.5 * np.log(r2[off] / s2[off]) / (4 * np.pi)
    np.fill_diagonal(Sd, -np.log(curve.speed) / (4 * np.pi))
    ir2 = np.zeros((n, n))
    ir2[off] = 1.0 / r2[off]
    rxx = dx * dx * ir2
    rxy = dx * dy * ir2
    ryy = dy * dy * ir2
    np.fill_diagonal(rxx, curve.tangent_x**2)
    np.fill_diagonal(rxy, curve.tangent_x * curve.tangent_y)
    np.fill_diagonal(ryy, curve.tangent_y**2)
    dt = curve.dt / (4 * np.pi)
    sp = curve.speed[None, :]
    # logA already includes its quadrature weights; smooth parts use dt
    Axx = (logA + (Sd * curve.dt + rxx * dt)) * sp
    Axy = (rxy * dt) * sp
    Ayy = (logA + (Sd * curve.dt + ryy * dt)) * sp
    return _block(Axx, Axy, Axy, Ayy)


def stokes_dlp_self(curve: BoundaryCurve) -> np.ndarray:
    """(2N, 2N) on-surface DLP (stresslet) velocity matrix: kernel is smooth
    with diagonal limit -(kappa/2pi) tau_i tau_j."""
    n = curve.N
    dx, dy, r2 = _geom(curve, curve.x, curve.y)
    off = ~np.eye(n, dtype=bool)
    rn = dx * curve.normal_x[None, :] + dy * curve.normal_y[None, :]
    c = np.zeros((n, n))
    c[off] = rn[off] / (r2[off] ** 2)
    Axx = c * dx * dx
    Axy = c * dx * dy
    Ayy = c * dy * dy
    lim = -curve.curvature / 2.0
    np.fill_diagonal(Axx, lim * curve.tangent_x**2)
    np.fill_diagonal(Axy, lim * curve.tangent_x * curve.tangent_y)
    np.fill_diagonal(Ayy, lim * curve.tangent_y**2)
    w = curve.weights[None, :] / np.pi
    return _block(Axx * w, Axy * w, Axy * w, Ayy * w)


def stokes_pressure_fix(src: BoundaryCurve, tx_n, ty_n) -> np.ndarray:
    """Rank completion n(x) (n(y).)/|Gamma| curing the DLP normal-flux
    nullspace (reference: examples/multi_stokes_for_paper.py
    Stokes_Pressure_Fix).  tx_n, ty_n: target normal components."""
    wx = src.normal_x * src.weights
    wy = src.normal_y * src.weights
    scale = 1.0 / np.sum(src.weights)  # 1/|Gamma|
    nxx = np.asarray(tx_n)[:, None] * wx[None, :]
    nxy = np.asarray(tx_n)[:, None] * wy[None, :]
    nyx = np.asarray(ty_n)[:, None] * wx[None, :]
    nyy = np.asarray(ty_n)[:, None] * wy[None, :]
    return _block(nxx, nxy, nyx, nyy) * scale


# ---------------------------------------------------------------------------
# dense Stokeslet apply (velocity + pressure from weighted forces)
# ---------------------------------------------------------------------------

def load_library() -> ctypes._CFuncPtr:
    """The Stokeslet kernel's launcher, built at first use."""
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    return build_library("stokes_slp", "stokes_slp_apply_f64",
                         [P, P, P, P, I64, P, P, P, P, P, I64, P, P, I64,
                          ctypes.c_int, P])


def fp64_math_probe(a):
    """(log a, 1 / a, 1 / sqrt(a), exp(-min(a, 700))) of a 1-D float64 CUDA
    tensor by the kernels' device math (``csrc/fp64_math.cuh``: ``log_pos``,
    ``rcp_pos``, ``rsqrt_pos``, ``exp_neg``), through a probe kernel in the
    Stokeslet library: what holds that math to torch's on the card."""
    check_f64_1d({"a": a}, {})
    if a.device.type != "cuda":
        raise ValueError(f"fp64_math_probe: needs a CUDA tensor, got "
                         f"{a.device}")
    P = ctypes.c_void_p
    fn = build_library("stokes_slp", "fp64_math_probe_f64",
                       [P, P, ctypes.c_int64, P, P, ctypes.c_int, P])
    n = a.shape[0]
    out = torch.empty(4 * n, dtype=torch.float64, device=a.device)
    if n:
        _launch("fp64_math_probe", fn,
                (a.data_ptr(), out.data_ptr(), n,
                 device_table("log_table", a.device).data_ptr(),
                 device_table("exp_table", a.device).data_ptr()), a.device)
    return out[:n], out[n:2 * n], out[2 * n:3 * n], out[3 * n:]


def stokes_slp_apply_plain(sx, sy, wfx, wfy, tx, ty):
    """Plain torch version of the Stokeslet sum with r^2 clamped at 1e-30
    in every term (as the TPU kernel does), as a chunked (T, S) sum.  The
    CPU path of ``stokes_slp_apply`` and the reference the CUDA kernel is
    checked against.  Returns (u, v, p), each (T,)."""
    S, T = sx.shape[0], tx.shape[0]
    kw = {"dtype": torch.float64, "device": tx.device}
    u, v, p = (torch.empty(T, **kw) for _ in range(3))
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(S, 1))
    for i0 in range(0, T, chunk):
        sl = slice(i0, i0 + chunk)
        dx = tx[sl, None] - sx[None, :]
        dy = ty[sl, None] - sy[None, :]
        r2 = (dx * dx + dy * dy).clamp_min_(_MIN_R2)
        ir2 = 1.0 / r2
        ilr = torch.log_(r2).mul_(-0.5)
        dxy = dx * dy * ir2
        u[sl] = (ilr + dx * dx * ir2) @ wfx + dxy @ wfy
        v[sl] = dxy @ wfx + (ilr + dy * dy * ir2) @ wfy
        p[sl] = (dx * ir2) @ wfx + (dy * ir2) @ wfy
    return u / (4 * math.pi), v / (4 * math.pi), p / (2 * math.pi)


def stokes_slp_apply(sx, sy, wfx, wfy, tx, ty):
    """Velocity (u, v) and pressure p, each (T,), at the targets from the
    weighted forces (wfx, wfy) at the sources.

    CPU tensors take ``stokes_slp_apply_plain``; CUDA tensors launch the
    FP64 kernel of ``csrc/stokes_slp.cu`` on the current stream and count
    the launch in ``stokes_slp_apply.launches``."""
    check_f64_1d({"sx": sx, "sy": sy, "wfx": wfx, "wfy": wfy},
                 {"tx": tx, "ty": ty})
    dev = tx.device
    if dev.type == "cpu":
        return stokes_slp_apply_plain(sx, sy, wfx, wfy, tx, ty)
    if dev.type != "cuda":
        raise ValueError(f"stokes_slp_apply: unsupported device {dev}")
    S, T = sx.shape[0], tx.shape[0]
    u, v, p = (torch.empty(T, dtype=torch.float64, device=dev)
               for _ in range(3))
    if T == 0:
        return u, v, p
    if S == 0:
        return u.zero_(), v.zero_(), p.zero_()
    fn = load_library()
    scratch = split_scratch("stokes_slp", T, S, 3, dev)
    _launch("stokes_slp", fn,
            (sx.data_ptr(), sy.data_ptr(), wfx.data_ptr(), wfy.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), u.data_ptr(), v.data_ptr(),
             p.data_ptr(), T, device_table("log_table", dev).data_ptr(),
             scratch.data_ptr(), scratch.numel()), dev)
    stokes_slp_apply.launches += 1
    return u, v, p


stokes_slp_apply.launches = 0
