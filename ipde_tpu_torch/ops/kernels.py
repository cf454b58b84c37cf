"""Dense layer-potential applies (f64): the port's FMM replacement.

Source counts in this framework are small (10^3-10^4 effective QFS sources)
while target counts are large (grid points), so the layer potentials are
dense quadrature sums evaluated on the fly.  On a CUDA tensor each sum runs
in a hand-written FP64 kernel (``csrc/laplace_slp.cu``: the Laplace single
layer; ``csrc/laplace_grad.cu``: its gradient; ``csrc/mh_slp.cu``: the
modified Helmholtz (Yukawa) single layer); on a CPU tensor it runs in the
plain torch version beside it.  The wrappers never fall back: a CUDA tensor
goes to the kernel, or the call raises.

All applies take sources as precomputed weighted charges (charge times
quadrature weight, folded in by the caller).
"""

from __future__ import annotations

import ctypes
import functools
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
# K0(z), the Yukawa kernel, split as the TPU kernel splits it
# (ipde_tpu/ops/pallas_ds.py _k0_ds, _k0_cheb_ds): a series for z < 2 (terms
# m = 1 .. 13), a Chebyshev fit of K0(z) e^z sqrt(z) in u = 1/z on [2, 36],
# and zero beyond z = 36 (K0(36) ~ 4e-17)
K0_SERIES_TERMS = 14
K0_CHEB_LO, K0_CHEB_HI, K0_CHEB_DEG = 2.0, 36.0, 26
_EULER_GAMMA = 0.5772156649015328606

_libs = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "ipde_tpu_torch cannot be built")
    return nvcc


def build_library(stem: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """Build (first use only) ``csrc/<stem>.cu`` into a shared library with
    a plain C interface, load it, and return its function ``symbol`` typed
    with ``argtypes``, returning an int (the launch's cudaError_t)."""
    fn = _libs.get(stem)
    if fn is None:
        path = build_shared(_CSRC / f"{stem}.cu", [_nvcc()] + _NVCC_FLAGS,
                            stem)
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fn = _libs.setdefault(stem, fn)
    return fn


def load_library() -> ctypes._CFuncPtr:
    """The Laplace kernel's launcher, built at first use."""
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    return build_library("laplace_slp", "laplace_slp_apply_f64",
                         [P, P, P, I64, P, P, P, I64, ctypes.c_int, P])


def load_grad_library() -> ctypes._CFuncPtr:
    """The Laplace gradient kernel's launcher, built at first use."""
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    return build_library("laplace_grad", "laplace_grad_apply_f64",
                         [P, P, P, I64, P, P, P, P, I64, ctypes.c_int, P])


def load_mh_library() -> ctypes._CFuncPtr:
    """The Yukawa kernel's launcher, built at first use."""
    P, I64, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    return build_library("mh_slp", "mh_slp_apply_f64",
                         [P, P, P, I64, P, P, P, I64, D, P, ctypes.c_int,
                          D, D, D, D, ctypes.c_int, P])


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
    raise if the launch failed."""
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
    _launch("laplace_slp", load_library(),
            (sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), out.data_ptr(), T), dev)
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
    _launch("laplace_grad", load_grad_library(),
            (sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), gx.data_ptr(), gy.data_ptr(), T),
            dev)
    laplace_slp_grad_apply.launches += 1
    return gx, gy


laplace_slp_grad_apply.launches = 0


@functools.lru_cache(maxsize=1)
def k0_cheb_coeffs() -> np.ndarray:
    """The (K0_CHEB_DEG,) Chebyshev coefficients of f(z) = K0(z) e^z sqrt(z)
    in u = 1/z on [1/36, 1/2], fitted on the host in float64 (the map to
    1/z moves the singularity at z = 0 away: degree 26 reaches ~2e-15 where
    a fit in z needs ~60); raises if the fit's residual exceeds 3e-15.  The
    one source of these numbers: the CUDA kernel is handed them."""
    from scipy.special import k0
    n = 400
    ulo, uhi = 1.0 / K0_CHEB_HI, 1.0 / K0_CHEB_LO
    xc = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    zc = 1.0 / (0.5 * (uhi + ulo) + 0.5 * (uhi - ulo) * xc)
    fv = k0(zc) * np.exp(zc) * np.sqrt(zc)
    c = np.polynomial.chebyshev.chebfit(xc, fv, K0_CHEB_DEG - 1)
    resid = np.abs(np.polynomial.chebyshev.chebval(xc, c) - fv) / fv
    if not resid.max() < 3e-15:
        raise RuntimeError(f"K0 Chebyshev fit residual {resid.max():.2e}")
    c.setflags(write=False)
    return c


def _k0_cheb_map():
    """(scale, shift) of x = scale * u + shift, mapping u = 1/z in
    [1/K0_CHEB_HI, 1/K0_CHEB_LO] onto the Chebyshev interval [-1, 1]."""
    ulo, uhi = 1.0 / K0_CHEB_HI, 1.0 / K0_CHEB_LO
    return 2.0 / (uhi - ulo), -(uhi + ulo) / (uhi - ulo)


def k0_split(z, q):
    """K0(z) elementwise by the kernels' split, given z >= 0 and q = z^2/4
    (the applies form q from r^2 directly, as the TPU kernel does).  Works
    in place on its temporaries: it is the CPU path of ``mh_slp_apply``."""
    small = z < K0_CHEB_LO
    qs = torch.where(small, q, 1.0)
    term = torch.ones_like(qs)
    i0 = torch.ones_like(qs)
    acc = torch.zeros_like(qs)
    harmonic = 0.0
    for m in range(1, K0_SERIES_TERMS):
        term.mul_(qs).mul_(1.0 / (m * m))         # q^m / (m!)^2
        i0.add_(term)
        harmonic += 1.0 / m
        acc.add_(term, alpha=harmonic)
    # K0 = sum_m H_m q^m / (m!)^2 - (log(z/2) + gamma) I0(z)
    series = acc.sub_(qs.log_().mul_(0.5).add_(_EULER_GAMMA).mul_(i0))
    zc = z.clamp(K0_CHEB_LO, K0_CHEB_HI)
    u = zc.reciprocal()
    scale, shift = _k0_cheb_map()
    x = u * scale + shift
    x2 = 2.0 * x
    c = k0_cheb_coeffs()
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for ck in c[:0:-1]:
        # Clenshaw: b1 <- 2 x b1 - b2 + c_k, b2 <- b1 (new b1 in b2's place)
        b1, b2 = b2.neg_().add_(ck).addcmul_(x2, b1), b1
    mid = (b2.neg_().add_(c[0]).addcmul_(x, b1)
           .mul_(zc.neg_().exp_()).mul_(u.sqrt_()))
    return torch.where(small, series,
                       torch.where(z > K0_CHEB_HI, 0.0, mid))


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


_k0_cheb_dev = {}


def mh_slp_apply(sx, sy, weighted_charge, tx, ty, k: float):
    """sum_j K0(k |t - s_j|) / (2 pi) * q_j at each target (T,): the Yukawa
    single layer, (k^2 - lap) G = delta.

    CPU tensors take ``mh_slp_apply_plain``; CUDA tensors launch the FP64
    kernel of ``csrc/mh_slp.cu`` on the current stream and count the launch
    in ``mh_slp_apply.launches``."""
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
    cheb = _k0_cheb_dev.get(dev)
    if cheb is None:
        cheb = _k0_cheb_dev.setdefault(
            dev, torch.tensor(k0_cheb_coeffs(), device=dev))
    _launch("mh_slp", load_mh_library(),
            (sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
             tx.data_ptr(), ty.data_ptr(), out.data_ptr(), T, k,
             cheb.data_ptr(), cheb.numel(), K0_CHEB_LO, K0_CHEB_HI,
             *_k0_cheb_map()), dev)
    mh_slp_apply.launches += 1
    return out


mh_slp_apply.launches = 0
