"""Native (C++) geometry kernels, bound via ctypes.

The coordinate solve is the geometry-setup hot path.  `grid_near_coords`
does the whole near-curve pipeline -- polyline stamping, Newton iteration
from Fourier coefficients, width filtering -- in one OpenMP-parallel native
call.  The library is built from ``coords.cpp`` at first use into
``build/ipde_tpu_torch/``; a failed build raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ipde_tpu_torch.utils.build import build_shared, host_cpu

_SRC = Path(__file__).resolve().parent / "coords.cpp"
_CXX = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib = None


def get_lib():
    """Load the native library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    path = build_shared(_SRC, _CXX, "coords", key_extra=host_cpu())
    lib = ctypes.CDLL(str(path))
    f = lib.grid_near_coords
    f.restype = ctypes.c_int64
    f.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    print(f"[ipde_tpu_torch] grid coordinates: native path ({path.name})",
          flush=True)
    _lib = lib
    return _lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def grid_near_coords_native(bdy, xv: np.ndarray, yv: np.ndarray,
                            width: float, newton_tol: float = 1e-14,
                            max_iter: int = 50, upsample: int = 4):
    """Native near-curve coordinate solve on a uniform grid.

    Returns (ix, iy, t, r) like geometry.coords.grid_points_near_curve.
    """
    lib = get_lib()
    nb = bdy.N
    xh_c = np.fft.rfft(bdy.x)
    yh_c = np.fft.rfft(bdy.y)
    xcr = np.ascontiguousarray(xh_c.real)
    xci = np.ascontiguousarray(xh_c.imag)
    ycr = np.ascontiguousarray(yh_c.real)
    yci = np.ascontiguousarray(yh_c.imag)
    bx = np.ascontiguousarray(bdy.x)
    by = np.ascontiguousarray(bdy.y)
    nx, ny = xv.size, yv.size
    hx = xv[1] - xv[0]
    hy = yv[1] - yv[0]
    # capacity: generous bound on the near-band cell count; on overflow the
    # kernel reports -total_needed and the call is repeated at that size
    cap = int(4 * upsample * nb * (2 * (width / min(hx, hy)) + 8)) + 1024
    while True:
        out_ix = np.empty(cap, np.int32)
        out_iy = np.empty(cap, np.int32)
        out_t = np.empty(cap, np.float64)
        out_r = np.empty(cap, np.float64)
        out_cv = np.empty(cap, np.uint8)
        n = int(lib.grid_near_coords(
            _ptr(bx, ctypes.c_double), _ptr(by, ctypes.c_double),
            ctypes.c_int64(nb),
            _ptr(xcr, ctypes.c_double), _ptr(xci, ctypes.c_double),
            _ptr(ycr, ctypes.c_double), _ptr(yci, ctypes.c_double),
            ctypes.c_double(xv[0]), ctypes.c_double(hx), ctypes.c_int64(nx),
            ctypes.c_double(yv[0]), ctypes.c_double(hy), ctypes.c_int64(ny),
            ctypes.c_double(width), ctypes.c_double(newton_tol),
            ctypes.c_int(max_iter), ctypes.c_int(upsample),
            _ptr(out_ix, ctypes.c_int32), _ptr(out_iy, ctypes.c_int32),
            _ptr(out_t, ctypes.c_double), _ptr(out_r, ctypes.c_double),
            _ptr(out_cv, ctypes.c_uint8), ctypes.c_int64(cap)))
        if n >= 0:
            return (out_ix[:n].copy(), out_iy[:n].copy(), out_t[:n].copy(),
                    out_r[:n].copy())
        cap = -n
