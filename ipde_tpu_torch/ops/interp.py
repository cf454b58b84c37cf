"""Spectral interpolation from periodic grids to fixed scattered targets.

The framework's NUFFT replacement (the reference calls finufft's type-2
transform: radial->grid and grid->interface; SURVEY.md section 2.2).  The
targets are geometry-static, so each plan precomputes on the host what its
device apply needs.

``make_interpolator`` keeps the routing of ``ipde_tpu.ops.interp``, so both
packages give a problem the same interpolator classes.  This port carries
``ExactInterp2D`` (exact trigonometric sums as two complex matmuls), which is
what the routing picks for the interface plan and the radial->grid plans of
the Poisson solve at nb=1200, M=16 and at the test sizes.  The window-NUFFT
classes ``PeriodicInterpolator2D`` and ``HybridInterp2D`` are not ported
yet and raise ``NotImplementedError`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# ---------------------------------------------------------------------------
# ES kernel (host)
# ---------------------------------------------------------------------------

def _es_kernel(z, beta):
    """phi(z) = exp(beta (sqrt(1-z^2) - 1)) on |z|<=1, else 0."""
    z = np.asarray(z)
    out = np.zeros_like(z)
    good = np.abs(z) < 1.0
    out[good] = np.exp(beta * (np.sqrt(1.0 - z[good] ** 2) - 1.0))
    return out


def _es_kernel_deriv(z, beta):
    """phi'(z) = -beta z / sqrt(1-z^2) * phi(z) on |z|<1, else 0 (the
    exponential kills the sqrt singularity)."""
    z = np.asarray(z)
    out = np.zeros_like(z)
    good = np.abs(z) < 1.0 - 1e-12
    s = np.sqrt(1.0 - z[good] ** 2)
    out[good] = -beta * z[good] / s * np.exp(beta * (s - 1.0))
    return out


@functools.lru_cache(maxsize=32)
def _es_kernel_ft_table(w: int, beta: float, half_width: float, nk: int):
    """Continuous FT phi_hat(k) = int_{-a}^{a} phi(y/a) e^{-iky} dy for
    k = 0..nk-1 (integer wavenumbers), a = half_width. Gauss-Legendre."""
    a = half_width
    xq, wq = np.polynomial.legendre.leggauss(max(200, 4 * w))
    y = a * xq
    vals = _es_kernel(xq, beta) * (a * wq)
    k = np.arange(nk)
    # even kernel -> cosine transform
    return (np.cos(np.outer(k, y)) * vals).sum(axis=1)


# ---------------------------------------------------------------------------
# interpolators
# ---------------------------------------------------------------------------

class PeriodicInterpolator2D:
    """ES-window type-2 NUFFT (ipde_tpu.ops.interp.PeriodicInterpolator2D).
    Not ported yet: ROADMAP.md Queue 1 item 5."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PeriodicInterpolator2D is not ported to ipde_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 5)")


class HybridInterp2D:
    """Exact-in-x, window-NUFFT-in-y interpolation
    (ipde_tpu.ops.interp.HybridInterp2D).  Not ported yet: ROADMAP.md
    Queue 1 item 5."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "HybridInterp2D is not ported to ipde_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 5)")


class ExactInterp2D:
    """Exact type-2 evaluation for small mode grids via factorized matmuls.

    u(t) = Re sum_{kx} e^{i kx tx} sum_{ky} e^{i ky ty} c[kx, ky] / (nx ny)
    with the (T, ny) and (T, nx) phase matrices precomputed on the host (the
    same cos/sin values as ipde_tpu) and kept on ``device`` in complex128.
    """

    def __init__(self, nx: int, ny: int, tx, ty, x_offset: float = 0.0,
                 y_offset: float = 0.0, *, device):
        self.nx, self.ny = nx, ny
        txa = np.asarray(tx, np.float64).ravel() - x_offset
        tya = np.asarray(ty, np.float64).ravel() - y_offset
        kxn = np.fft.fftfreq(nx, 1.0 / nx)
        kyn = np.fft.fftfreq(ny, 1.0 / ny)
        self.T = txa.size

        def phases(t, k):
            ang = np.outer(t, k)
            ph = np.empty(ang.shape, np.complex128)
            ph.real = np.cos(ang)
            ph.imag = np.sin(ang)
            return torch.as_tensor(ph, device=device)

        self.EY = phases(tya, kyn)                       # (T, ny)
        self.EX = phases(txa, kxn)                       # (T, nx)
        self.ikx = torch.as_tensor(1j * kxn, dtype=torch.complex128,
                                   device=device)
        self.iky = torch.as_tensor(1j * kyn, dtype=torch.complex128,
                                   device=device)

    def _cols(self, c):
        """(B, nx, ny) modes -> (ny, B*nx) with per-field column groups."""
        B = c.shape[0]
        return c.permute(2, 0, 1).reshape(self.ny, B * self.nx), B

    def _many_from_modes(self, c):
        """(B, nx, ny) complex modes -> (B, T) real values."""
        C, B = self._cols(c)
        g = (self.EY @ C).reshape(self.T, B, self.nx)
        out = torch.einsum("tbx,tx->bt", g, self.EX).real
        return out / (self.nx * self.ny)

    def from_modes(self, c):
        """c: (nx, ny) or (B, nx, ny) unnormalized fft2 modes."""
        if c.dim() == 3:
            return self._many_from_modes(c)
        return self._many_from_modes(c[None])[0]

    def from_modes_grad(self, c):
        """(value, d/dtx, d/dty) at the targets, each (T,) or (B, T): exact
        trigonometric differentiation (the ik factors fold into the phase
        matrices)."""
        batched = c.dim() == 3
        C, B = self._cols(c if batched else c[None])
        g = (self.EY @ C).reshape(self.T, B, self.nx)
        dg = ((self.EY * self.iky) @ C).reshape(self.T, B, self.nx)
        norm = 1.0 / (self.nx * self.ny)
        val = torch.einsum("tbx,tx->bt", g, self.EX).real * norm
        ddx = torch.einsum("tbx,tx->bt", g, self.EX * self.ikx).real * norm
        ddy = torch.einsum("tbx,tx->bt", dg, self.EX).real * norm
        if batched:
            return val, ddx, ddy
        return val[0], ddx[0], ddy[0]

    def __call__(self, f):
        """f: real (nx, ny) or (B, nx, ny) grid values."""
        if f.dim() == 3:
            return self._many_from_modes(torch.fft.fft2(f))
        return self._many_from_modes(torch.fft.fft2(f)[None])[0]


def make_interpolator(nx: int, ny: int, tx, ty, x_offset: float = 0.0,
                      y_offset: float = 0.0, exact_max_modes: int = 65536,
                      exact_max_targets: int = 8192, *, device):
    """Pick the interpolator exactly as ipde_tpu.ops.interp.make_interpolator
    does (exact trig matmuls for small mode grids or few targets, the window
    NUFFT otherwise) and print which class the plan gets."""
    T = np.asarray(tx).size
    exact_flops = T * nx * ny
    nufft_flops = 40 * (2 * nx) * (2 * ny) * (np.log2(max(nx * ny, 2)))
    exact_mem_ok = T * max(nx, ny) <= 2 ** 21
    exact_T_ok = T <= 4 * exact_max_targets
    kw = {}
    if ((nx * ny <= exact_max_modes and (nx > 64 or exact_T_ok))
            or (T <= exact_max_targets and exact_flops < nufft_flops
                and exact_mem_ok)):
        cls = ExactInterp2D
        kw = {"device": device}
    elif nx <= 64:
        cls = HybridInterp2D
    elif T * 8 <= nx * ny:
        cls = PeriodicInterpolator2D
        kw = {"sigma": 1.25, "w": 24}
    else:
        cls = PeriodicInterpolator2D
    print(f"[ipde_tpu_torch] interpolator: {nx}x{ny} modes, {T} targets "
          f"-> {cls.__name__}", flush=True)
    return cls(nx, ny, tx, ty, x_offset=x_offset, y_offset=y_offset, **kw)
