"""Dense layer-potential applies (f64): the port's FMM replacement.

Source counts in this framework are small (10^3-10^4 effective QFS sources)
while target counts are large (grid points), so the layer potentials are
dense quadrature sums evaluated on the fly.  On a CUDA tensor the sum runs in
the hand-written FP64 kernel ``csrc/laplace_slp.cu``; on a CPU tensor it runs
in the plain torch version beside it.  The wrapper never falls back: a CUDA
tensor goes to the kernel, or the call raises.

All applies take sources as precomputed weighted charges (charge times
quadrature weight, folded in by the caller).
"""

from __future__ import annotations

import ctypes
import math
import shutil
from pathlib import Path

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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load_library()(
        sx.data_ptr(), sy.data_ptr(), weighted_charge.data_ptr(), S,
        tx.data_ptr(), ty.data_ptr(), out.data_ptr(), T, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"laplace_slp kernel launch failed: "
                           f"cudaError_t {err}")
    laplace_slp_apply.launches += 1
    return out


laplace_slp_apply.launches = 0
