"""Device-side formation of dense layer-potential matrices.

Twins of the numpy builders in ops/singular.py and ops/stokes_kernels.py
that build the SAME matrices as torch tensors on ``device`` from O(nb) curve
data (the curve's device mirror, ``BoundaryCurve.dev``): a Stokes QFS system
at nb=2700 is (5400 x 16200) float64 = 700 MB, formed where it is composed
instead of on the host and copied.  Used by the ``"device"`` backend of the
QFS maps (qfs/qfs.py) and of the BIEs (solvers/bie.py).

Each builder is one eager pass of elementwise torch ops in float64
(``torch.log``; ``torch.special.modified_bessel_k0/k1`` for the Yukawa
kernel); the rule-36 filters run through ``torch.fft`` in complex128, as the
host ``qfs._filter_rows`` does with numpy.  Equality with the numpy builders
is asserted in tests/test_torch_forms_dev.py (ipde_tpu.ops.forms_dev's
twins, which are the same matrices).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.ops import singular as sq
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.ops.singular import log_quad_circulant

_f64 = torch.float64


class FormBuilders:
    """The form builders of one setup backend, by the host builders' names:
    for ``"device"`` this module's ``<name>_dev`` on ``device``, for
    ``"host"`` the numpy builders of ops/singular.py and
    ops/stokes_kernels.py; ``eye`` and ``lift`` (a host-built form, such as
    the Yukawa self forms, as the backend's array) to match."""

    def __init__(self, backend: str, device):
        if backend not in ("host", "device"):
            raise ValueError(f"unknown setup backend {backend!r}")
        self.device = device if backend == "device" else None

    def form(self, name: str):
        if self.device is None:
            return getattr(sq, name, None) or getattr(sk, name)
        return functools.partial(globals()[name + "_dev"], device=self.device)

    def eye(self, n: int):
        if self.device is None:
            return np.eye(n)
        return torch.eye(n, dtype=_f64, device=self.device)

    def lift(self, a):
        return a if self.device is None else torch.as_tensor(
            a, device=self.device)


def _t(v, device) -> torch.Tensor:
    """Targets (numpy or torch) as a flat float64 tensor on ``device``."""
    return torch.as_tensor(v, dtype=_f64, device=device).reshape(-1)


def _pair(src: dict, tx, ty):
    dx = tx[:, None] - src["x"][None, :]
    dy = ty[:, None] - src["y"][None, :]
    return dx, dy, dx * dx + dy * dy


def _blocks(axx, axy, ayx, ayy):
    return torch.cat([torch.cat([axx, axy], dim=1),
                      torch.cat([ayx, ayy], dim=1)], dim=0)


def _kress_circulant(n: int, device) -> torch.Tensor:
    """The Kress log-quadrature circulant (ops/singular.log_quad_circulant),
    expanded on ``device`` from its first column."""
    col = torch.as_tensor(log_quad_circulant(n)[:, 0], device=device)
    i = torch.arange(n, device=device)
    return col[(i[:, None] - i[None, :]) % n]


# ---------------------------------------------------------------------------
# naive (off-surface) forms
# ---------------------------------------------------------------------------

def laplace_slp_naive_dev(src: BoundaryCurve, tx, ty, *, device):
    s = src.dev(device)
    _, _, r2 = _pair(s, _t(tx, device), _t(ty, device))
    return -torch.log(r2) / (4 * np.pi) * s["weights"][None, :]


def laplace_dlp_naive_dev(src: BoundaryCurve, tx, ty, *, device):
    s = src.dev(device)
    dx, dy, r2 = _pair(s, _t(tx, device), _t(ty, device))
    dot = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    return dot / (2 * np.pi * r2) * s["weights"][None, :]


def mh_slp_naive_dev(src: BoundaryCurve, tx, ty, k: float, *, device):
    s = src.dev(device)
    _, _, r2 = _pair(s, _t(tx, device), _t(ty, device))
    return (torch.special.modified_bessel_k0(k * torch.sqrt(r2))
            / (2 * np.pi) * s["weights"][None, :])


def mh_dlp_naive_dev(src: BoundaryCurve, tx, ty, k: float, *, device):
    s = src.dev(device)
    dx, dy, r2 = _pair(s, _t(tx, device), _t(ty, device))
    r = torch.sqrt(r2)
    dot = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    return (k * torch.special.modified_bessel_k1(k * r) * dot
            / (2 * np.pi * r) * s["weights"][None, :])


def laplace_slp_normal_naive_dev(src: BoundaryCurve, tx, ty, tnx, tny, *,
                                 device):
    s = src.dev(device)
    dx, dy, r2 = _pair(s, _t(tx, device), _t(ty, device))
    dot = dx * _t(tnx, device)[:, None] + dy * _t(tny, device)[:, None]
    return -dot / (2 * np.pi * r2) * s["weights"][None, :]


def mh_slp_normal_naive_dev(src: BoundaryCurve, tx, ty, tnx, tny, k: float,
                            *, device):
    s = src.dev(device)
    dx, dy, r2 = _pair(s, _t(tx, device), _t(ty, device))
    r = torch.sqrt(r2)
    dot = dx * _t(tnx, device)[:, None] + dy * _t(tny, device)[:, None]
    return (-k * torch.special.modified_bessel_k1(k * r) * dot
            / (2 * np.pi * r) * s["weights"][None, :])


def stokes_slp_naive_dev(src: BoundaryCurve, tx, ty, *, device):
    """(2T, 2S) velocity matrix of the Stokes single layer."""
    s = src.dev(device)
    dx, dy, r2 = _pair(s, _t(tx, device), _t(ty, device))
    ilr = -0.5 * torch.log(r2)
    ir2 = 1.0 / r2
    w = s["weights"][None, :] / (4 * np.pi)
    axy = (dx * dy * ir2) * w
    return _blocks((ilr + dx * dx * ir2) * w, axy, axy,
                   (ilr + dy * dy * ir2) * w)


def stokes_dlp_naive_dev(src: BoundaryCurve, tx, ty, *, device):
    """(2T, 2S) velocity matrix of the Stokes double layer (stresslet)."""
    s = src.dev(device)
    dx, dy, r2 = _pair(s, _t(tx, device), _t(ty, device))
    rn = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    c = rn / (r2 * r2) * (s["weights"][None, :] / np.pi)
    cxy = c * dx * dy
    return _blocks(c * dx * dx, cxy, cxy, c * dy * dy)


# ---------------------------------------------------------------------------
# Kress self-evaluation forms (Laplace and Stokes; the Yukawa self forms stay
# host-built: banded Kress split with scipy i0/i1 and trig oversampling)
# ---------------------------------------------------------------------------

def _self_geom(s: dict):
    dx, dy, r2 = _pair(s, s["x"], s["y"])
    t = s["t"]
    s2 = 4.0 * torch.sin((t[:, None] - t[None, :]) / 2.0) ** 2
    eye = torch.eye(t.shape[0], dtype=torch.bool, device=t.device)
    return dx, dy, r2, s2, eye


def laplace_slp_self_dev(curve: BoundaryCurve, *, device):
    s = curve.dev(device)
    _, _, r2, s2, eye = _self_geom(s)
    # off-diagonal smooth remainder -log(r2/s2)/(4pi); diagonal -log(speed^2)
    ratio = torch.where(eye, 1.0, r2 / torch.where(eye, 1.0, s2))
    K2 = torch.where(eye, -torch.log(s["speed"] ** 2)[:, None],
                     -torch.log(ratio)) / (4 * np.pi)
    W = _kress_circulant(curve.N, device)
    return (-W / (4 * np.pi) + K2 * curve.dt) * s["speed"][None, :]


def laplace_dlp_self_dev(curve: BoundaryCurve, *, device):
    s = curve.dev(device)
    dx, dy, r2, _, eye = _self_geom(s)
    dot = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    K = torch.where(eye, -s["curvature"][:, None] / (4 * np.pi),
                    dot / (2 * np.pi * torch.where(eye, 1.0, r2)))
    return K * s["weights"][None, :]


def laplace_slp_normal_self_dev(curve: BoundaryCurve, *, device):
    s = curve.dev(device)
    dx, dy, r2, _, eye = _self_geom(s)
    dot = dx * s["normal_x"][:, None] + dy * s["normal_y"][:, None]
    K = torch.where(eye, -s["curvature"][:, None] / (4 * np.pi),
                    -dot / (2 * np.pi * torch.where(eye, 1.0, r2)))
    return K * s["weights"][None, :]


def stokes_slp_self_dev(curve: BoundaryCurve, *, device):
    """(2N, 2N) on-surface Stokes single-layer velocity matrix."""
    s = curve.dev(device)
    dx, dy, r2, s2, eye = _self_geom(s)
    logA = -_kress_circulant(curve.N, device) / (8 * np.pi)
    ratio = torch.where(eye, 1.0, r2 / torch.where(eye, 1.0, s2))
    Sd = torch.where(eye, -torch.log(s["speed"])[:, None],
                     -0.5 * torch.log(ratio)) / (4 * np.pi)
    ir2 = torch.where(eye, 0.0, 1.0 / torch.where(eye, 1.0, r2))
    tx, ty = s["tangent_x"], s["tangent_y"]
    rxx = torch.where(eye, (tx ** 2)[:, None], dx * dx * ir2)
    rxy = torch.where(eye, (tx * ty)[:, None], dx * dy * ir2)
    ryy = torch.where(eye, (ty ** 2)[:, None], dy * dy * ir2)
    dt = curve.dt
    dtq = dt / (4 * np.pi)
    sp = s["speed"][None, :]
    Axy = (rxy * dtq) * sp
    return _blocks((logA + (Sd * dt + rxx * dtq)) * sp, Axy, Axy,
                   (logA + (Sd * dt + ryy * dtq)) * sp)


def stokes_dlp_self_dev(curve: BoundaryCurve, *, device):
    """(2N, 2N) on-surface Stokes double-layer (stresslet) velocity
    matrix."""
    s = curve.dev(device)
    dx, dy, r2, _, eye = _self_geom(s)
    rn = dx * s["normal_x"][None, :] + dy * s["normal_y"][None, :]
    c = torch.where(eye, 0.0, rn / torch.where(eye, 1.0, r2 * r2))
    lim = -s["curvature"] / 2.0
    tx, ty = s["tangent_x"], s["tangent_y"]
    Axx = torch.where(eye, (lim * tx ** 2)[:, None], c * dx * dx)
    Axy = torch.where(eye, (lim * tx * ty)[:, None], c * dx * dy)
    Ayy = torch.where(eye, (lim * ty ** 2)[:, None], c * dy * dy)
    w = s["weights"][None, :] / np.pi
    return _blocks(Axx * w, Axy * w, Axy * w, Ayy * w)


def stokes_pressure_fix_dev(src: BoundaryCurve, tx_n, ty_n, *, device):
    """The rank completion n(x) (n(y) .) / |Gamma| of
    ops/stokes_kernels.stokes_pressure_fix."""
    s = src.dev(device)
    wx = (s["normal_x"] * s["weights"])[None, :]
    wy = (s["normal_y"] * s["weights"])[None, :]
    txn = _t(tx_n, device)[:, None]
    tyn = _t(ty_n, device)[:, None]
    return _blocks(txn * wx, txn * wy, tyn * wx, tyn * wy) \
        / torch.sum(s["weights"])


# ---------------------------------------------------------------------------
# the rule-36 spectral filter per component block
# ---------------------------------------------------------------------------

def _rule36(n: int, device) -> torch.Tensor:
    """exp(-36 (k/kmax)^36) on the fftfreq grid (qfs._rule36)."""
    k = np.abs(np.fft.fftfreq(n, 1.0 / n))
    return torch.as_tensor(np.exp(-36.0 * (k / k.max()) ** 36),
                           device=device)


def filter_rows_dev(Bmat: torch.Tensor, ncurve: int) -> torch.Tensor:
    """F @ B applied spectrally to each ncurve-row component block of B."""
    rows, cols = Bmat.shape
    blk = Bmat.reshape(rows // ncurve, ncurve, cols)
    filt = _rule36(ncurve, Bmat.device)[None, :, None]
    out = torch.fft.ifft(filt * torch.fft.fft(blk, dim=1), dim=1).real
    return out.reshape(rows, cols)


def filter_cols_dev(Mmat: torch.Tensor, ncurve: int) -> torch.Tensor:
    """M @ F per ncurve-column component block (F is symmetric)."""
    rows, cols = Mmat.shape
    blk = Mmat.reshape(rows, cols // ncurve, ncurve)
    filt = _rule36(ncurve, Mmat.device)[None, None, :]
    out = torch.fft.ifft(filt * torch.fft.fft(blk, dim=2), dim=2).real
    return out.reshape(rows, cols)
