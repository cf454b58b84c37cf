"""Spectral interpolation from periodic grids to fixed scattered targets.

The framework's NUFFT replacement (the reference calls finufft's type-2
transform: radial->grid and grid->interface; SURVEY.md section 2.2).  The
targets are geometry-static, so each plan precomputes on the host what its
device apply needs.

``make_interpolator`` keeps the routing of ``ipde_tpu.ops.interp``, so both
packages give a problem the same interpolator classes.  This port carries
``ExactInterp2D`` (exact trigonometric sums as two complex matmuls), which the
routing picks for interface plans and for radial->grid plans with up to
32,768 targets, and ``HybridInterp2D`` (exact along the first axis, ES-window
NUFFT along the last), which it picks for radial->grid plans with more
targets, e.g. the bench geometry (star(1200, a=0.2, f=5), M=16, a 1024x1088
box).  The full window NUFFT ``PeriodicInterpolator2D`` is not ported yet and
raises ``NotImplementedError`` (ROADMAP.md, Queue 1).
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


def _es_beta(w: int, sigma: float) -> float:
    """ES shape parameter: finufft's rule beta = 2.30 w at sigma = 2,
    scaled like pi w (1 - 1/(2 sigma)) for other upsampling factors."""
    return 2.30 * w * (1.0 - 0.5 / sigma) / 0.75


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
    """Exact trigonometric evaluation along the FIRST axis, ES-window NUFFT
    along the LAST axis (ipde_tpu.ops.interp.HybridInterp2D).

    Built for the radial (Chebyshev-reflection) -> grid transfer, where the
    first axis holds only 2M Fourier modes while the targets number in the
    tens of thousands: the modes are deconvolved and zero-padded along y,
    one complex128 inverse FFT along dim 0 gives the (nfy, B*nx) fine-in-y
    array, and each target sums w of its rows against its (nx,) phases.
    The window weights, row indices, y-deconvolution and x-phases are built
    on the host once per plan, as ipde_tpu builds them.
    """

    def __init__(self, nx: int, ny: int, tx, ty, sigma: float = 2,
                 w: int = 16, x_offset: float = 0.0, y_offset: float = 0.0,
                 *, device):
        txa = np.asarray(tx, np.float64).ravel() - x_offset
        tya = np.mod(np.asarray(ty, np.float64).ravel() - y_offset,
                     2 * np.pi)
        self.nx, self.ny = nx, ny
        nfy = int(np.ceil(sigma * ny))
        hy = 2 * np.pi / nfy
        beta = _es_beta(w, sigma)
        half_w = w / 2.0
        jy = np.floor(tya / hy).astype(np.int64)
        oy = jy - (w // 2 - 1)
        py = oy[:, None] + np.arange(w)[None, :]
        zy = (tya[:, None] / hy - py) / half_w
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.wy = dev(_es_kernel(zy, beta))                       # (T, w)
        self.row_idx = dev(np.ascontiguousarray(np.mod(py, nfy).T))  # (w, T)
        ky = np.abs(np.fft.fftfreq(ny, 1.0 / ny)).astype(int)
        phy = _es_kernel_ft_table(w, beta, half_w * hy, int(ky.max()) + 1)
        self.deconv_y = dev(hy / phy[ky])                         # (ny,)
        kxn = np.fft.fftfreq(nx, 1.0 / nx)
        ang = np.outer(txa, kxn)
        E = np.empty(ang.shape, np.complex128)                    # (T, nx)
        E.real = np.cos(ang)
        E.imag = np.sin(ang)
        self.E = dev(E)
        self.nfy = nfy
        self.T = txa.size
        self.w = w

    def _many_from_modes(self, c):
        """(B, nx, ny) complex modes -> (B, T) real values.  The fields ride
        the column axis of the fine y-transform and of each row gather."""
        B = c.shape[0]
        d = self.deconv_y * (self.nfy / (self.nx * self.ny))
        D = (c * d).permute(2, 0, 1).reshape(self.ny, B * self.nx)
        hy = self.ny // 2
        ry = self.ny - hy
        P = D.new_zeros((self.nfy, B * self.nx))
        P[:hy] = D[:hy]
        P[self.nfy - ry:] = D[hy:]
        F = torch.fft.ifft(P, dim=0)                      # (nfy, B*nx)
        acc = torch.zeros((self.T, B), dtype=torch.float64, device=c.device)
        for q in range(self.w):
            rows = F.index_select(0, self.row_idx[q]).reshape(self.T, B,
                                                               self.nx)
            val = torch.einsum("tbx,tx->tb", rows, self.E).real
            acc += self.wy[:, q, None] * val
        return acc.T

    def from_modes(self, c):
        """c: (nx, ny) or (B, nx, ny) unnormalized fft2 modes."""
        if c.dim() == 3:
            return self._many_from_modes(c)
        return self._many_from_modes(c[None])[0]

    def __call__(self, f):
        """f: real (nx, ny) or (B, nx, ny) grid values."""
        if f.dim() == 3:
            return self._many_from_modes(torch.fft.fft2(f))
        return self._many_from_modes(torch.fft.fft2(f)[None])[0]


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
        kw = {"device": device}
    elif T * 8 <= nx * ny:
        cls = PeriodicInterpolator2D
        kw = {"sigma": 1.25, "w": 24}
    else:
        cls = PeriodicInterpolator2D
    print(f"[ipde_tpu_torch] interpolator: {nx}x{ny} modes, {T} targets "
          f"-> {cls.__name__}", flush=True)
    return cls(nx, ny, tx, ty, x_offset=x_offset, y_offset=y_offset, **kw)
