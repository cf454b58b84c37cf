"""Dense layer-potential applies (f64): the port's FMM replacement.

Source counts in this framework are small (10^3-10^4 effective QFS sources)
while target counts are large (grid points), so the layer potentials are
dense quadrature sums evaluated on the fly.  On a CUDA tensor each sum runs
in a hand-written FP64 kernel (``csrc/laplace_slp.cu``: the Laplace single
layer; ``csrc/laplace_grad.cu``: its gradient; ``csrc/mh_slp.cu``: the
modified Helmholtz (Yukawa) single layer; the Stokeslet's is bound in
``ops/stokes_kernels.py``); on a CPU tensor it runs in the plain torch
version beside it.  The wrappers never fall back: a CUDA tensor goes to the
kernel, or the call raises.

Every kernel takes its log, reciprocal, exp and K0 from
``csrc/fp64_math.cuh`` and ``csrc/mh_slp.cu``, not from the CUDA library;
every table and coefficient those use is made here on the host
(``log_table``, ``exp_table``, ``k0_fit``) and handed to them, and
``fast_log``, ``fast_exp_neg`` and ``k0_split`` are the same algorithms in
torch, which the CPU tests hold.  A launch with few targets splits its
sources across blocks: the launcher says into how many ranges
(``split_count``) and the wrapper hands it the scratch tensor for the
partial sums (``split_scratch``).

All applies take sources as precomputed weighted charges (charge times
quadrature weight, folded in by the caller).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import shutil
from pathlib import Path

import numpy as np
import torch

from ipde_tpu_torch.utils.build import build_shared

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# r^2 below this is clamped (coincident pairs stay finite); the TPU
# kernel's value, ipde_tpu/ops/pallas_ds.py _pair_geometry
_MIN_R2 = 1e-30
# (T-chunk x S) f64 elements per step of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 24
# K0(z), the Yukawa kernel, split at the TPU kernel's points
# (ipde_tpu/ops/pallas_ds.py _k0_ds, _k0_cheb_ds): a series for z < 2, fits
# of K0(z) e^z sqrt(z) in u = 1/z on [2, 36], and zero beyond z = 36
# (K0(36) ~ 4e-17).  The branch is picked from q = z^2 / 4, which the applies
# form from r^2 without a root.  Series: K0 = R(q) - (log(q)/2 + gamma) I0,
# with I0 and R fitted as polynomials of K0_SERIES_DEG coefficients in q on
# [0, 1].  Fits: one polynomial of K0_CHEB_DEG coefficients on each
# sub-interval of K0_CHEB_BREAKS, in u mapped onto [-1, 1]
K0_SERIES_DEG = 9
K0_CHEB_LO, K0_CHEB_HI, K0_CHEB_DEG = 2.0, 36.0, 11
K0_CHEB_BREAKS = (K0_CHEB_LO, 3.5, 7.0, K0_CHEB_HI)
_EULER_GAMMA = 0.5772156649015328606
# the table of the kernels' FP64 log (csrc/fp64_math.cuh): 2^bits intervals
# of the mantissa, taken in [sqrt(1/2), sqrt(2)) as in fdlibm.  The Stokeslet
# and Yukawa kernels use 6 bits (8 KB of shared memory beside their other
# tables), the Laplace kernel 8 (32 KB, two FP64 instructions fewer per log)
LOG_TABLE_BITS = 6
LAPLACE_LOG_TABLE_BITS = 8
_LOG_SQRT_HALF_HI = 0x3fe6a09e       # high word of sqrt(1/2)
_LN2_HI = float.fromhex("0x1.62e42feep-1")          # 21 trailing zero bits
_LN2_LO = float.fromhex("0x1.a39ef35793c76p-33")    # log(2) - _LN2_HI

_libs = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "ipde_tpu_torch cannot be built")
    return nvcc


def library_path(stem: str) -> Path:
    """Build (first use only) ``csrc/<stem>.cu`` into a shared library and
    return its path.  The library's name is keyed on the source, the compile
    command and every header of ``csrc/``, so an edited header builds anew
    like an edited source."""
    headers = hashlib.sha256()
    for h in sorted(_CSRC.glob("*.cuh")):
        headers.update(h.name.encode() + b"\0" + h.read_bytes())
    return build_shared(_CSRC / f"{stem}.cu", [_nvcc()] + _NVCC_FLAGS, stem,
                        key_extra=headers.hexdigest())


def build_library(stem: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """Build (first use only) ``csrc/<stem>.cu`` into a shared library with
    a plain C interface, load it, and return its function ``symbol`` typed
    with ``argtypes``, returning an int (a launcher's cudaError_t)."""
    fn = _libs.get((stem, symbol))
    if fn is None:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs.setdefault(stem, ctypes.CDLL(str(library_path(stem))))
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fn = _libs.setdefault((stem, symbol), fn)
    return fn


def load_library() -> ctypes._CFuncPtr:
    """The Laplace kernel's launcher, built at first use."""
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    return build_library("laplace_slp", "laplace_slp_apply_f64",
                         [P, P, P, I64, P, P, P, I64, P, P, P, I64,
                          ctypes.c_int, P])


def load_grad_library() -> ctypes._CFuncPtr:
    """The Laplace gradient kernel's launcher, built at first use."""
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    return build_library("laplace_grad", "laplace_grad_apply_f64",
                         [P, P, P, I64, P, P, P, P, I64, P, I64,
                          ctypes.c_int, P])


def load_mh_library() -> ctypes._CFuncPtr:
    """The Yukawa kernel's launcher, built at first use."""
    P, I64, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    return build_library("mh_slp", "mh_slp_apply_f64",
                         [P, P, P, I64, P, P, P, I64, D, P, ctypes.c_int, P,
                          P, P, P, I64, ctypes.c_int, P])


@functools.lru_cache(maxsize=256)
def split_count(stem: str, T: int, S: int) -> int:
    """The number of source ranges the launcher of ``csrc/<stem>.cu`` will
    split S sources into for T targets (1: no split, no scratch).  The
    launcher's own choice, from T and S alone, so it is asked once per
    shape: a solve repeats a handful of shapes."""
    fn = build_library(stem, f"{stem}_split_count",
                       [ctypes.c_int64, ctypes.c_int64])
    return fn(T, S)


def split_scratch(stem: str, T: int, S: int, n_out: int, dev):
    """The scratch tensor the launcher of ``csrc/<stem>.cu`` needs for T
    targets, S sources and ``n_out`` outputs: (splits * n_out * T,), empty
    when the launcher will not split."""
    n = split_count(stem, T, S)
    return torch.empty(n * n_out * T if n > 1 else 0, dtype=torch.float64,
                       device=dev)


def check_f64_1d(sources: dict, targets: dict):
    """Raise unless every array is a contiguous 1-D float64 tensor on one
    device, the sources of one length and the targets of another."""
    args = {**sources, **targets}
    dev = next(iter(args.values())).device
    for name, a in args.items():
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if a.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {a.dtype}")
        if a.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the others on {dev}")
    for group in (sources, targets):
        if len({a.shape[0] for a in group.values()}) > 1:
            raise ValueError(f"{', '.join(group)} must have one length")


def _launch(name: str, fn, args, dev: torch.device):
    """Call the launcher ``fn`` with ``args`` + (device, current stream);
    raise if the launch failed.  The launcher sets the CUDA device to
    ``dev`` and does not set it back: the call runs under torch's device
    guard, which restores the caller's current device."""
    with torch.cuda.device(dev):
        err = fn(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def laplace_slp_apply_plain(sx, sy, weighted_charge, tx, ty):
    """Plain torch version: sum_j -log(max(r^2, 1e-30)) q_j / (4 pi), as a
    chunked (T, S) sum.  The CPU path of ``laplace_slp_apply`` and the
    reference the CUDA kernel is checked against."""
    S, T = sx.shape[0], tx.shape[0]
    out = torch.empty(T, dtype=torch.float64, device=tx.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(S, 1))
    for i0 in range(0, T, chunk):
        cx = tx[i0:i0 + chunk, None]
        cy = ty[i0:i0 + chunk, None]
        dx = cx - sx[None, :]
        dy = cy - sy[None, :]
        r2 = (dx * dx + dy * dy).clamp_min_(_MIN_R2)
        out[i0:i0 + chunk] = -(torch.log_(r2) @ weighted_charge)
    return out / (4 * math.pi)


def laplace_slp_apply(sx, sy, weighted_charge, tx, ty):
    """sum_j -log|t - s_j| / (2 pi) * q_j at each target (T,).

    CPU tensors take ``laplace_slp_apply_plain``; CUDA tensors launch the
    FP64 kernel of ``csrc/laplace_slp.cu`` on the current stream and count
    the launch in ``laplace_slp_apply.launches``."""
    check_f64_1d({"sx": sx, "sy": sy, "weighted_charge": weighted_charge},
                 {"tx": tx, "ty": ty})
    dev = tx.device
    if dev.type == "cpu":
        return laplace_slp_apply_plain(sx, sy, weighted_charge, tx, ty)
    if dev.type != "cuda":
        raise ValueError(f"laplace_slp_apply: unsupported device {dev}")
    S, T = sx.shape[0], tx.shape[0]
    out = torch.empty(T, dtype=torch.float64, device=dev)
    if T == 0:
        return out
    if S == 0:
        return out.zero_()
    fn = load_library()
    scratch = split_scratch("laplace_slp", T, S, 1, dev)
    _launch("laplace_slp", fn,
            (sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), out.data_ptr(), T,
             device_table("laplace_log_table", dev).data_ptr(),
             log_table(LAPLACE_LOG_TABLE_BITS).ctypes.data,
             scratch.data_ptr(), scratch.numel()), dev)
    laplace_slp_apply.launches += 1
    return out


laplace_slp_apply.launches = 0


def laplace_slp_grad_apply_plain(sx, sy, weighted_charge, tx, ty):
    """Plain torch version of the gradient: sum_j -(dx, dy) q_j /
    max(r^2, 1e-30) / (2 pi), as a chunked (T, S) sum; returns (gx, gy)."""
    S, T = sx.shape[0], tx.shape[0]
    gx, gy = (torch.empty(T, dtype=torch.float64, device=tx.device)
              for _ in range(2))
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(S, 1))
    for i0 in range(0, T, chunk):
        sl = slice(i0, i0 + chunk)
        dx = tx[sl, None] - sx[None, :]
        dy = ty[sl, None] - sy[None, :]
        ir2 = (dx * dx + dy * dy).clamp_min_(_MIN_R2).reciprocal_()
        gx[sl] = -((dx * ir2) @ weighted_charge)
        gy[sl] = -((dy * ir2) @ weighted_charge)
    return gx / (2 * math.pi), gy / (2 * math.pi)


def laplace_slp_grad_apply(sx, sy, weighted_charge, tx, ty):
    """(d/dx, d/dy) of the Laplace single layer at each target: (gx, gy),
    each (T,).

    CPU tensors take ``laplace_slp_grad_apply_plain``; CUDA tensors launch
    the FP64 kernel of ``csrc/laplace_grad.cu`` on the current stream and
    count the launch in ``laplace_slp_grad_apply.launches``."""
    check_f64_1d({"sx": sx, "sy": sy, "weighted_charge": weighted_charge},
                 {"tx": tx, "ty": ty})
    dev = tx.device
    if dev.type == "cpu":
        return laplace_slp_grad_apply_plain(sx, sy, weighted_charge, tx, ty)
    if dev.type != "cuda":
        raise ValueError(f"laplace_slp_grad_apply: unsupported device {dev}")
    S, T = sx.shape[0], tx.shape[0]
    gx, gy = (torch.empty(T, dtype=torch.float64, device=dev)
              for _ in range(2))
    if T == 0:
        return gx, gy
    if S == 0:
        return gx.zero_(), gy.zero_()
    fn = load_grad_library()
    scratch = split_scratch("laplace_grad", T, S, 2, dev)
    _launch("laplace_grad", fn,
            (sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), gx.data_ptr(), gy.data_ptr(), T,
             scratch.data_ptr(), scratch.numel()), dev)
    laplace_slp_grad_apply.launches += 1
    return gx, gy


laplace_slp_grad_apply.launches = 0


# ---------------------------------------------------------------------------
# the kernels' FP64 log: its table and its twin
# ---------------------------------------------------------------------------

# log1p(r) = r (1 + r Q(r)), Q(r) = -1/2 + r/3 - ... + r^5/7; a table of
# `bits` bits gives |r| < 2^-(bits + 0.9) and Q is cut at the degree that
# keeps the first dropped term, |r|^(degree + 3) / (degree + 3), below 2e-17
_LOG1P_Q = tuple((-1.0) ** (j + 1) / j for j in range(2, 8))
_LOG1P_DEGREE = {6: 5, 8: 3}


@functools.lru_cache(maxsize=None)
def log_table(bits: int = LOG_TABLE_BITS) -> np.ndarray:
    """What the kernels' FP64 log needs (``csrc/fp64_math.cuh`` ``log_pos``
    and ``log_normal``; ``fast_log`` is their twin), as one (2^bits + 5, 2)
    array: the table (c_i, -log c_i), then the constants in the order of the
    header's ``LogConsts``: log 2 split hi/lo, the six coefficients of Q (a
    table of more bits uses fewer), and the kernels' clamp of r^2.

    A positive normal a = 2^e m with m in [sqrt(1/2), sqrt(2)); interval i
    is the top ``bits`` bits of m's offset from sqrt(1/2) in the high word,
    c_i the reciprocal of the interval's midpoint cut to 20 bits, so that
    r = fma(m, c_i, -1) is small (|r| < 2^-(bits + 0.9)) and log a = e log 2
    - log c_i + log1p(r).  The interval that holds m = 1 has c = 1 exactly.
    The one source of these numbers: the kernels are handed them."""
    n = 1 << bits
    step = 1 << (20 - bits)
    edges = (((np.arange(n + 1, dtype=np.int64) * step + _LOG_SQRT_HALF_HI)
              << 32).view(np.float64))
    mant, ex = np.frexp(2.0 / (edges[:-1] + edges[1:]))
    c = np.ldexp(np.round(mant * 2.0 ** 20) / 2.0 ** 20, ex)
    c[(edges[:-1] <= 1.0) & (1.0 < edges[1:])] = 1.0
    r_max = np.maximum(edges[1:] * c - 1.0, 1.0 - edges[:-1] * c).max()
    degree = _LOG1P_DEGREE[bits]
    if not (r_max < 2.0 ** -(bits + 0.9)
            and r_max ** (degree + 3) / (degree + 3) < 2e-17):
        raise RuntimeError(f"log table: |r| reaches {r_max:.3e}")
    consts = np.array([_LN2_HI, _LN2_LO, *_LOG1P_Q, _MIN_R2, 0.0])
    table = np.concatenate([np.stack([c, -np.log(c)], axis=1),
                            consts.reshape(-1, 2)])
    table.setflags(write=False)
    return table


def fast_log(a, bits: int = LOG_TABLE_BITS, split_ln2: bool = True):
    """log(a) for positive normal float64 ``a`` by the kernels' algorithm
    (``csrc/fp64_math.cuh``): the table of ``bits`` bits, its polynomial and,
    with ``split_ln2``, log 2 added in two pieces (``log_pos``, what the
    Stokeslet and Yukawa kernels call with 6 bits) or else in one
    (``log_normal``, what the Laplace kernel calls with 8 bits); the kernel's
    fma(m, c_i, -1) is formed exactly by Dekker's splitting (c_i has 20
    bits).  Absolute error at most 4e-16 max(1, |log a|).  The CPU tests hold
    the algorithm through this twin; the applies' plain versions use
    ``torch.log``."""
    table = torch.tensor(log_table(bits), device=a.device)
    n = 1 << bits
    bits64 = a.contiguous().view(torch.int64)
    ha = (bits64 >> 32) - _LOG_SQRT_HALF_HI
    e = (ha >> 20).to(torch.float64)
    idx = (ha >> (20 - bits)) & (n - 1)
    m = ((((ha & 0xFFFFF) + _LOG_SQRT_HALF_HI) << 32)
         | (bits64 & 0xFFFFFFFF)).view(torch.float64)
    c, mlogc = table[idx, 0], table[idx, 1]
    t = m * 134217729.0                     # 2^27 + 1: m = m_hi + m_lo
    m_hi = t - (t - m)
    r = (m_hi * c - 1.0) + (m - m_hi) * c   # every product exact
    q = _LOG1P_Q[:_LOG1P_DEGREE[bits] + 1]
    h = torch.full_like(r, q[-1])
    for qj in q[-2::-1]:
        h = h * r + qj
    if split_ln2:
        return r * (r * h + 1.0) + (e * _LN2_LO + (e * _LN2_HI + mlogc))
    return e * (_LN2_HI + _LN2_LO) + (r * (r * h + 1.0) + mlogc)


EXP_TABLE_ENTRIES = 32
# e^r - 1 = r + r^2 (1/2 + r/6 + ... + r^4/720): |r|^7 / 5040 < 4e-18
_EXPM1_C = tuple(1.0 / math.factorial(j) for j in range(2, 7))


@functools.lru_cache(maxsize=1)
def exp_table() -> np.ndarray:
    """What the kernels' FP64 exp of a non-positive argument needs
    (``csrc/fp64_math.cuh`` ``exp_neg``; ``fast_exp_neg`` is its twin), as
    one flat array: 2^(j/32) for j < 32, then the constants in the order of
    the header's ``ExpConsts``: 32 / log 2, log(2) / 32 split hi/lo, and the
    five coefficients of (e^r - 1 - r) / r^2."""
    j = np.arange(EXP_TABLE_ENTRIES)
    table = np.concatenate([
        np.exp2(j / EXP_TABLE_ENTRIES),
        [EXP_TABLE_ENTRIES / math.log(2.0), _LN2_HI / EXP_TABLE_ENTRIES,
         _LN2_LO / EXP_TABLE_ENTRIES, *_EXPM1_C]])
    table.setflags(write=False)
    return table


def fast_exp_neg(t):
    """e^t for float64 ``t`` in [-700, 0] by the kernels' algorithm
    (``csrc/fp64_math.cuh`` ``exp_neg``): the same table, reduction and
    polynomial.  Relative error below 4e-16."""
    table = device_table("exp_table", t.device)
    n = EXP_TABLE_ENTRIES
    inv_step, step_hi, step_lo = (float(v) for v in table[n:n + 3])
    kf = torch.round(t * inv_step)
    kk = kf.to(torch.int64)
    r = (t - kf * step_hi) - kf * step_lo
    p = torch.full_like(r, _EXPM1_C[-1])
    for cj in _EXPM1_C[-2::-1]:
        p = p * r + cj
    tj = table[kk & (n - 1)]
    v = tj + tj * (r * r * p + r)
    return torch.ldexp(v, kk >> 5)


# ---------------------------------------------------------------------------
# K0 and the Yukawa single layer
# ---------------------------------------------------------------------------

def _horner_np(coeffs, x):
    h = np.zeros_like(x)
    for c in coeffs[::-1]:
        h = h * x + c
    return h


@functools.lru_cache(maxsize=1)
def k0_series_coeffs() -> np.ndarray:
    """(2, K0_SERIES_DEG) monomial coefficients in q = z^2 / 4 on [0, 1] of
    I0(z) = sum_m q^m / (m!)^2 (row 0) and of the regular part R(q) =
    sum_m H_m q^m / (m!)^2 (row 1) of K0 = R - (log(q)/2 + gamma) I0:
    Chebyshev fits of the 25-term sums, converted to monomials; raises if
    a Horner evaluation's residual exceeds 3e-15."""
    from numpy.polynomial import Chebyshev, Polynomial
    inv_fact2 = np.array([1.0 / math.factorial(m) ** 2 for m in range(25)])
    harmonic = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, 25))])
    n = 200
    q_fit = 0.5 * (np.cos(np.pi * (np.arange(n) + 0.5) / n) + 1.0)
    q_chk = np.linspace(0.0, 1.0, 2001)
    rows = []
    for taylor in (inv_fact2, inv_fact2 * harmonic):
        fit = Chebyshev.fit(q_fit, _horner_np(taylor, q_fit),
                            K0_SERIES_DEG - 1, domain=[0.0, 1.0])
        mono = fit.convert(kind=Polynomial, domain=[-1, 1],
                           window=[-1, 1]).coef
        want = _horner_np(taylor, q_chk)
        resid = np.abs(_horner_np(mono, q_chk) - want) / want.clip(1.0)
        if not resid.max() < 3e-15:
            raise RuntimeError(f"K0 series fit residual {resid.max():.2e}")
        rows.append(mono)
    out = np.stack(rows)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1)
def k0_cheb_coeffs() -> np.ndarray:
    """(len(K0_CHEB_BREAKS) - 1, 2 + K0_CHEB_DEG) rows (scale, shift, a_0,
    ..., a_{K0_CHEB_DEG - 1}): on the sub-interval [z_i, z_{i+1}] of
    K0_CHEB_BREAKS, f(z) = K0(z) e^z sqrt(z) = sum_j a_j x^j with x = scale
    u + shift, u = 1/z mapped onto [-1, 1].  Fitted on the host in float64
    (the map to 1/z moves the singularity at z = 0 away) as Chebyshev
    series converted to monomials; raises if a Horner evaluation's
    residual exceeds 3e-15.  The one source of these numbers: the CUDA
    kernel is handed them."""
    from scipy.special import k0e
    n = 400
    xc = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    x_chk = np.linspace(-1.0, 1.0, 4001)
    rows = []
    for z_lo, z_hi in zip(K0_CHEB_BREAKS[:-1], K0_CHEB_BREAKS[1:]):
        ulo, uhi = 1.0 / z_hi, 1.0 / z_lo
        scale, shift = 2.0 / (uhi - ulo), -(uhi + ulo) / (uhi - ulo)
        f = lambda x: (lambda z: k0e(z) * np.sqrt(z))(  # noqa: E731
            scale / (x - shift))
        mono = np.polynomial.chebyshev.cheb2poly(
            np.polynomial.chebyshev.chebfit(xc, f(xc), K0_CHEB_DEG - 1))
        resid = np.abs(_horner_np(mono, x_chk) - f(x_chk)) / f(x_chk)
        if not resid.max() < 3e-15:
            raise RuntimeError(f"K0 fit residual {resid.max():.2e} on "
                               f"[{z_lo}, {z_hi}]")
        rows.append(np.concatenate([[scale, shift], mono]))
    out = np.stack(rows)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1)
def k0_fit() -> np.ndarray:
    """Everything ``csrc/mh_slp.cu`` needs of K0, as one flat float64 array
    in the order of its ``K0Fit``: the thresholds of q = z^2 / 4 (series
    below the first, zero beyond the last, the fits' sub-intervals
    between), the two series polynomials, the fits' rows."""
    out = np.concatenate([np.square(K0_CHEB_BREAKS) / 4.0,
                          k0_series_coeffs().ravel(),
                          k0_cheb_coeffs().ravel()])
    out.setflags(write=False)
    return out


def _horner_(coeffs, x):
    """sum_j coeffs[j] x^j as a new tensor."""
    h = torch.full_like(x, float(coeffs[-1]))
    for c in coeffs[-2::-1]:
        h.mul_(x).add_(float(c))
    return h


def k0_split(z, q):
    """K0(z) elementwise by the kernels' split, given z >= 0 and q = z^2/4
    (the applies form q from r^2 directly, as the TPU kernel does); the
    branch is picked from q, with the coefficients the CUDA kernel is
    handed.  Works in place on its temporaries: it is the CPU path of
    ``mh_slp_apply``."""
    q_breaks = np.square(K0_CHEB_BREAKS) / 4.0
    small = q < q_breaks[0]
    qs = torch.where(small, q, 1.0)
    i0_c, reg_c = k0_series_coeffs()
    # K0 = R(q) - (log(q)/2 + gamma) I0
    series = _horner_(reg_c, qs).sub_(
        _horner_(i0_c, qs).mul_(qs.log_().mul_(0.5).add_(_EULER_GAMMA)))
    zc = z.clamp(K0_CHEB_LO, K0_CHEB_HI)
    u = zc.reciprocal()
    rows = k0_cheb_coeffs()
    mid = None
    for i, row in enumerate(rows):
        f = _horner_(row[2:], u * row[0] + row[1])
        mid = f if mid is None else torch.where(q > q_breaks[i], f, mid)
    mid.mul_(zc.neg_().exp_()).mul_(u.sqrt_())
    return torch.where(small, series,
                       torch.where(q > q_breaks[-1], 0.0, mid))


def mh_slp_apply_plain(sx, sy, weighted_charge, tx, ty, k: float):
    """Plain torch version: sum_j K0(k max(r^2, 1e-30)^(1/2)) q_j / (2 pi)
    by ``k0_split``, as a chunked (T, S) sum.  The CPU path of
    ``mh_slp_apply`` and the reference the CUDA kernel is checked
    against."""
    S, T = sx.shape[0], tx.shape[0]
    out = torch.empty(T, dtype=torch.float64, device=tx.device)
    # small chunks: k0_split runs ~60 passes over each (chunk, S) block
    chunk = max(1, _PLAIN_CHUNK_ELEMS // 64 // max(S, 1))
    kq = k * k / 4.0
    for i0 in range(0, T, chunk):
        sl = slice(i0, i0 + chunk)
        dx = tx[sl, None] - sx[None, :]
        dy = ty[sl, None] - sy[None, :]
        r2 = (dx * dx + dy * dy).clamp_min_(_MIN_R2)
        out[sl] = k0_split(torch.sqrt(r2) * k, r2 * kq) @ weighted_charge
    return out / (2 * math.pi)


def _spread_bits(v):
    """Bit j of the int64 tensor ``v`` (j < 21) moved to bit 2 j."""
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                        (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                        (1, 0x5555555555555555)):
        v = (v | (v << shift)) & mask
    return v


def spatial_order(tx, ty, cell: float | None = None):
    """A permutation (T,) int64 that puts the targets in Morton (Z) order
    of the square cells of side ``cell`` they fall in (default: the side
    that gives one target per cell of their bounding box on average); ties
    keep their order.  On a box grid of spacing ``cell`` 32 consecutive
    targets are then an 8 x 4 patch and 256 a 16 x 16 one, so a warp's and
    a block's targets are close together: the Yukawa kernel's lanes then
    mostly take one branch of K0, and its warps can skip sources out of
    reach.  A solver orders its fixed target sets once, together with the
    indices it scatters the results to.  The kernels are right for any
    order."""
    T = tx.shape[0]
    if T == 0:
        return torch.empty(0, dtype=torch.int64, device=tx.device)
    x = torch.nan_to_num(tx, nan=0.0, posinf=0.0, neginf=0.0)
    y = torch.nan_to_num(ty, nan=0.0, posinf=0.0, neginf=0.0)
    x0, y0 = x.min(), y.min()
    if cell is None:
        cell = math.sqrt(max(float((x.max() - x0) * (y.max() - y0)) / T,
                             1e-300))
    ix = ((x - x0) / cell).floor().clamp_(0, (1 << 21) - 1).to(torch.int64)
    iy = ((y - y0) / cell).floor().clamp_(0, (1 << 21) - 1).to(torch.int64)
    key = _spread_bits(ix) | (_spread_bits(iy) << 1)
    return torch.argsort(key, stable=True)


_dev_tables = {}


def device_table(name: str, dev):
    """The host table ``log_table`` (6 bits), ``laplace_log_table`` (the log
    table of LAPLACE_LOG_TABLE_BITS bits), ``exp_table`` or ``k0_fit`` as a
    tensor on ``dev``, uploaded once."""
    t = _dev_tables.get((name, dev))
    if t is None:
        host = {"log_table": log_table, "exp_table": exp_table,
                "k0_fit": k0_fit, "laplace_log_table": functools.partial(
                    log_table, LAPLACE_LOG_TABLE_BITS)}[name]()
        t = _dev_tables.setdefault((name, dev),
                                   torch.tensor(host, device=dev))
    return t


def mh_slp_apply(sx, sy, weighted_charge, tx, ty, k: float):
    """sum_j K0(k |t - s_j|) / (2 pi) * q_j at each target (T,): the Yukawa
    single layer, (k^2 - lap) G = delta.

    CPU tensors take ``mh_slp_apply_plain``; CUDA tensors launch the FP64
    kernel of ``csrc/mh_slp.cu`` on the current stream and count the launch
    in ``mh_slp_apply.launches``.  The kernel is fastest on targets in
    ``spatial_order`` and right for any order."""
    check_f64_1d({"sx": sx, "sy": sy, "weighted_charge": weighted_charge},
                 {"tx": tx, "ty": ty})
    k = float(k)
    if not (math.isfinite(k) and k > 0.0):
        raise ValueError(f"mh_slp_apply: k must be finite and > 0, got {k}")
    dev = tx.device
    if dev.type == "cpu":
        return mh_slp_apply_plain(sx, sy, weighted_charge, tx, ty, k)
    if dev.type != "cuda":
        raise ValueError(f"mh_slp_apply: unsupported device {dev}")
    S, T = sx.shape[0], tx.shape[0]
    out = torch.empty(T, dtype=torch.float64, device=dev)
    if T == 0:
        return out
    if S == 0:
        return out.zero_()
    fit = k0_fit()
    fn = load_mh_library()
    scratch = split_scratch("mh_slp", T, S, 1, dev)
    _launch("mh_slp", fn,
            (sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), out.data_ptr(), T, k,
             fit.ctypes.data, fit.size,
             device_table("k0_fit", dev).data_ptr(),
             device_table("log_table", dev).data_ptr(),
             device_table("exp_table", dev).data_ptr(), scratch.data_ptr(),
             scratch.numel()), dev)
    mh_slp_apply.launches += 1
    return out


mh_slp_apply.launches = 0


# -- the exponential integral E1 (the periodic Laplace evaluator's near
# correction; plain torch FP64, no kernel of its own) -------------------------

def _e1_series(x: torch.Tensor) -> torch.Tensor:
    """E1(x) = -gamma - log x - sum_m (-x)^m / (m m!), 30 terms summed
    smallest first (x <= 1.75)."""
    terms = []
    term = torch.ones_like(x)
    for m in range(1, 31):
        term = term * (-x) / m
        terms.append(term / m)
    acc = torch.zeros_like(x)
    for t in reversed(terms):
        acc = acc - t
    return (-_EULER_GAMMA - torch.log(x)) + acc


def _e1_continued_fraction(x: torch.Tensor) -> torch.Tensor:
    """E1(x) = e^-x / (x + 1 - 1 / (x + 3 - 4 / (x + 5 - ...))) by the
    modified Lentz method, 56 terms (x >= 1.75)."""
    b = x + 1.0
    c = torch.full_like(x, 1e300)
    d = 1.0 / b
    h = d
    for i in range(1, 56):
        an = -float(i * i)
        b = b + 2.0
        d = 1.0 / (an * d + b)
        c = b + an / c
        h = h * (c * d)
    return h * torch.exp(-x)


def expint_e1(x: torch.Tensor) -> torch.Tensor:
    """E1(x) for float64 x > 0, within 1e-14 relative of scipy's exp1 on
    [1e-8, 44]: the power series up to 1.75, the continued fraction above,
    clamped at 44 (E1(44) ~ 2e-21: callers' arguments are eta^2 r^2 <=
    ~40).  ipde_tpu.ops.kernels.expint_e1 fits x e^x E1(x) on [1, 44] by
    one degree-48 Chebyshev series, 2e-8 off near x = 1."""
    small = x < 1.75
    xs = torch.where(small, x.clamp_min(1e-300), 1.0)
    xl = torch.where(small, 1.75, x.clamp_max(44.0))
    return torch.where(small, _e1_series(xs), _e1_continued_fraction(xl))
