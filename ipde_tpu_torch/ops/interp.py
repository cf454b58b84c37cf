"""Spectral interpolation from periodic grids to fixed scattered targets.

The framework's NUFFT replacement (the reference calls finufft's type-2
transform: radial->grid, grid->interface, grid->points; SURVEY.md section
2.2).  The targets are geometry-static, so each plan precomputes what its
device apply needs: window weights, indices and deconvolution tables on the
host, and the trigonometric phase matrices (``phase_matrix``) on the plan's
device from the (T,) target coordinates.

``make_interpolator`` keeps the routing of ``ipde_tpu.ops.interp``, so both
packages give a problem the same interpolator classes: ``ExactInterp2D``
(exact trigonometric sums as two complex matmuls) for small mode grids or
few targets, ``HybridInterp2D`` (exact along the first axis, ES-window NUFFT
along the last) for radial->grid plans with many targets, and the full
ES-window NUFFT ``PeriodicInterpolator2D`` for box grids of more than 65,536
modes with many targets (e.g. the interface plan of bench tier 2,
star(2700, a=0.2, f=5), M=20, a ~2048^2 box: sigma 1.25, w 24).  The
semi-Lagrangian point partitions (geometry/partition.py) use
``PeriodicInterpolator2D`` for their zone-1 points.  ``nufft2d2_exact``
(direct sum) and ``PolyInterpolator2D`` (periodic Lagrange stencils) are
the validation and initialisation helpers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ipde_tpu_torch.utils.profiling import count


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


def phase_matrix(t, k, *, device) -> torch.Tensor:
    """exp(i outer(t, k)) as a (T, n) complex128 tensor built on ``device``
    from the (T,) coordinates ``t`` and the (n,) wavenumbers ``k``.

    The angle is the same IEEE float64 product as ``np.outer(t, k)``; cos
    and sin are taken on the device and written straight into the real and
    imaginary parts of the output, so no (T, n) array lives on the host and
    nothing but the output is allocated at full size.  Counted as
    ``interp.phase_entries``."""
    t = torch.as_tensor(np.asarray(t, np.float64).ravel(), device=device)
    k = torch.as_tensor(np.asarray(k, np.float64).ravel(), device=device)
    out = torch.empty((t.numel(), k.numel()), dtype=torch.complex128,
                      device=device)
    re, im = out.real, out.imag
    torch.mul(t[:, None], k[None, :], out=re)      # the angle
    torch.sin(re, out=im)
    re.cos_()
    count("interp.phase_entries", out.numel())
    return out


# ---------------------------------------------------------------------------
# interpolators
# ---------------------------------------------------------------------------

class NufftPlan(NamedTuple):
    """Device-side plan for fixed-target type-2 interpolation."""
    flat_idx: torch.Tensor   # (T, w*w) int64 indices into the raveled fine grid
    wx: torch.Tensor         # (T, w)
    wy: torch.Tensor         # (T, w)
    wxd: torch.Tensor        # (T, w) d/dt of wx in the plan's [0, 2pi) units
    wyd: torch.Tensor        # (T, w)
    deconv: torch.Tensor     # (nx, ny) real deconvolution of the mode array
    nx: int
    ny: int
    nfx: int
    nfy: int


def build_nufft_plan(nx: int, ny: int, tx: np.ndarray, ty: np.ndarray,
                     sigma: float = 2, w: int = 16,
                     x_offset: float = 0.0, y_offset: float = 0.0, *,
                     device) -> NufftPlan:
    """Precompute the interpolation structure for targets (tx, ty) in
    [0, 2pi)^2 on the host (the same numbers as
    ipde_tpu.ops.interp.build_nufft_plan) and put it on ``device``.

    The mode array to be interpolated has shape (nx, ny) in fftfreq order.
    x_offset/y_offset shift the fine grid's origin (used for half-node-offset
    Chebyshev reflections in the radial interpolation).
    """
    tx = np.mod(np.asarray(tx, np.float64).ravel() - x_offset, 2 * np.pi)
    ty = np.mod(np.asarray(ty, np.float64).ravel() - y_offset, 2 * np.pi)
    nfx, nfy = int(np.ceil(sigma * nx)), int(np.ceil(sigma * ny))
    hx, hy = 2 * np.pi / nfx, 2 * np.pi / nfy
    beta = _es_beta(w, sigma)
    half_w = w / 2.0
    # nearest fine-grid index and window start
    jx = np.floor(tx / hx).astype(np.int64)
    jy = np.floor(ty / hy).astype(np.int64)
    ox = jx - (w // 2 - 1)   # window covers [ox, ox + w)
    oy = jy - (w // 2 - 1)
    px = (ox[:, None] + np.arange(w)[None, :])
    py = (oy[:, None] + np.arange(w)[None, :])
    # kernel arguments: distance in fine-grid units / half-width
    zx = (tx[:, None] / hx - px) / half_w
    zy = (ty[:, None] / hy - py) / half_w
    # window derivatives in the plan's t-units (dz/dt = 1/(h half_w))
    wxd = _es_kernel_deriv(zx, beta) / (hx * half_w)
    wyd = _es_kernel_deriv(zy, beta) / (hy * half_w)
    pxm = np.mod(px, nfx)
    pym = np.mod(py, nfy)
    flat = (pxm[:, :, None] * nfy + pym[:, None, :]).reshape(tx.size, w * w)
    # deconvolution: divide mode (kx, ky) by phat(kx) phat(ky) / (hx hy)
    kx = np.abs(np.fft.fftfreq(nx, 1.0 / nx)).astype(int)
    ky = np.abs(np.fft.fftfreq(ny, 1.0 / ny)).astype(int)
    phx = _es_kernel_ft_table(w, beta, half_w * hx, int(kx.max()) + 1)
    phy = _es_kernel_ft_table(w, beta, half_w * hy, int(ky.max()) + 1)
    deconv = (hx / phx[kx])[:, None] * (hy / phy[ky])[None, :]
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return NufftPlan(
        flat_idx=dev(flat), wx=dev(_es_kernel(zx, beta)),
        wy=dev(_es_kernel(zy, beta)), wxd=dev(wxd), wyd=dev(wyd),
        deconv=dev(deconv), nx=nx, ny=ny, nfx=nfx, nfy=nfy)


def _pad_modes_half(c: torch.Tensor, nx, ny, nfx, nfy) -> torch.Tensor:
    """Zero-pad fft2 modes (..., nx, ny) of a REAL field to the HALF
    spectrum (..., nfx//2 + 1, nfy) of the fine grid (even nx only).

    Satisfies irfft2 of this == Re(ifft2(full zero-padding)): taking the
    real part Hermitian-symmetrizes the full padded array, which SPLITS each
    input Nyquist line (row nx/2, and column ny/2 when ny is even)
    half-and-half between the +/- placements -- exact for real-field
    inputs, whose Nyquist lines are self-conjugate (the placements of
    ipde_tpu.ops.interp._pad_modes_half)."""
    hx, hy = nx // 2, ny // 2
    rows = c.new_zeros(c.shape[:-1] + (nfy,))            # (..., nx, nfy)
    if ny % 2 == 0:
        rows[..., :hy] = c[..., :hy]
        rows[..., hy] = 0.5 * c[..., hy]
        rows[..., nfy - hy] = 0.5 * c[..., hy]
        rows[..., nfy - hy + 1:] = c[..., hy + 1:]
    else:
        rows[..., :hy + 1] = c[..., :hy + 1]
        rows[..., nfy - hy:] = c[..., hy + 1:]
    out = c.new_zeros(c.shape[:-2] + (nfx // 2 + 1, nfy))
    out[..., :hx, :] = rows[..., :hx, :]
    out[..., hx, :] = 0.5 * rows[..., hx, :]
    return out


def _pad_modes(c: torch.Tensor, nx, ny, nfx, nfy) -> torch.Tensor:
    """Zero-pad an (..., nx, ny) fftfreq-ordered mode array to
    (..., nfx, nfy): the (n + 1) // 2 modes k >= 0 of each axis keep their
    place, the rest (k < 0) go to the end.  ipde_tpu.ops.interp._pad_modes
    keeps n // 2 in front, which for an odd n moves the mode k = (n - 1) / 2
    to -(n + 1) / 2; even n place alike."""
    out = c.new_zeros(c.shape[:-2] + (nfx, nfy))
    px, py = (nx + 1) // 2, (ny + 1) // 2
    rx, ry = nx - px, ny - py
    out[..., :px, :py] = c[..., :px, :py]
    out[..., :px, nfy - ry:] = c[..., :px, py:]
    out[..., nfx - rx:, :py] = c[..., px:, :py]
    out[..., nfx - rx:, nfy - ry:] = c[..., px:, py:]
    return out


class PeriodicInterpolator2D:
    """Interpolates real periodic grid data (or given modes) to fixed
    targets by the ES-window type-2 NUFFT
    (ipde_tpu.ops.interp.PeriodicInterpolator2D):

        modes -> deconvolve -> zero-pad to the (nfx, nfy) = ceil(sigma n)
        fine grid -> inverse FFT (torch.fft.irfft2 of the half spectrum for
        even nx, the real part of the full ifft2 for odd nx) -> gather each
        target's w x w window -> weighted reduction.

    Usage:
        interp = PeriodicInterpolator2D(nx, ny, tx, ty, device=dev)
        vals = interp(f)            # f real (nx, ny) or (B, nx, ny) -> (T,) / (B, T)
        vals = interp.from_modes(c) # c complex unnormalized fft2 modes

    The x_offset/y_offset arguments place the data grid's first sample at
    that coordinate.  sigma=2, w=16 gives ~1e-14 in float64; make_interpolator
    takes sigma=1.25, w=24 (2.56x less fine-grid area, ~1e-15 kernel error)
    for few targets on a big grid.

    The window gather holds (B, t, w, w) values: the targets are taken in
    chunks of at most GATHER_MAX_ELEMS / (B w^2) (2^25 values, 256 MiB in
    float64; zone 1 of a bench-size grid, ~6e5 targets, and the six fields
    of interpolate_many at w = 24 would otherwise gather ~7.4 GB at once).
    """

    GATHER_MAX_ELEMS = 2 ** 25

    def __init__(self, nx: int, ny: int, tx, ty, sigma: float = 2,
                 w: int = 16, x_offset: float = 0.0, y_offset: float = 0.0,
                 *, device):
        self.plan = build_nufft_plan(nx, ny, tx, ty, sigma, w, x_offset,
                                     y_offset, device=device)
        self.T = np.asarray(tx).size
        self.w = w

    def _fine(self, c: torch.Tensor) -> torch.Tensor:
        """(B, nx, ny) complex modes -> (B, nfx * nfy) real fine grids."""
        p = self.plan
        cd = c * (p.deconv * (p.nfx * p.nfy / (p.nx * p.ny)))
        if p.nx % 2 == 0:
            cp = _pad_modes_half(cd, p.nx, p.ny, p.nfx, p.nfy)
            fine = torch.fft.irfft2(cp.transpose(-1, -2), s=(p.nfy, p.nfx))\
                .transpose(-1, -2)
        else:
            cp = _pad_modes(cd, p.nx, p.ny, p.nfx, p.nfy)
            fine = torch.fft.ifft2(cp).real
        return fine.reshape(c.shape[0], p.nfx * p.nfy)

    def _chunks(self, B: int):
        step = max(1, self.GATHER_MAX_ELEMS // (B * self.w * self.w))
        return [slice(a, min(a + step, self.T))
                for a in range(0, self.T, step)] or [slice(0, 0)]

    def _reduce(self, c: torch.Tensor, grad: bool):
        """(B, nx, ny) modes -> (B, T) values, and with ``grad`` the two
        window-derivative reductions too."""
        p = self.plan
        fine = self._fine(c)
        B, w = fine.shape[0], self.w
        outs = [[] for _ in range(3 if grad else 1)]
        for sl in self._chunks(B):
            patches = fine[:, p.flat_idx[sl]].reshape(B, -1, w, w)
            py = torch.einsum("btpq,tq->btp", patches, p.wy[sl])
            outs[0].append(torch.einsum("btp,tp->bt", py, p.wx[sl]))
            if grad:
                outs[1].append(torch.einsum("btp,tp->bt", py, p.wxd[sl]))
                pyd = torch.einsum("btpq,tq->btp", patches, p.wyd[sl])
                outs[2].append(torch.einsum("btp,tp->bt", pyd, p.wx[sl]))
        return [torch.cat(o, dim=1) for o in outs]

    def from_modes(self, c: torch.Tensor) -> torch.Tensor:
        """c: (nx, ny) or (B, nx, ny) complex *unnormalized* fft2 modes."""
        if c.dim() == 3:
            return self._reduce(c, False)[0]
        return self._reduce(c[None], False)[0][0]

    def from_modes_grad(self, c: torch.Tensor):
        """(vals, d/dtx, d/dty), each (T,) or (B, T), from ONE fine
        transform: the derivatives differentiate the window interpolant
        itself (weights wxd / wyd), in the plan's [0, 2pi) coordinates;
        callers scale by 2pi / period."""
        if c.dim() == 3:
            return tuple(self._reduce(c, True))
        return tuple(o[0] for o in self._reduce(c[None], True))

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        """f: real (nx, ny) or (B, nx, ny) grid values."""
        return self.from_modes(torch.fft.fft2(f))


class HybridInterp2D:
    """Exact trigonometric evaluation along the FIRST axis, ES-window NUFFT
    along the LAST axis (ipde_tpu.ops.interp.HybridInterp2D).

    Built for the radial (Chebyshev-reflection) -> grid transfer, where the
    first axis holds only 2M Fourier modes while the targets number in the
    tens of thousands: the modes are deconvolved and zero-padded along y,
    one complex128 inverse FFT along dim 0 gives the (nfy, B*nx) fine-in-y
    array, and each target sums w of its rows against its (nx,) phases.
    The window weights, row indices and y-deconvolution are built on the
    host once per plan, as ipde_tpu builds them; the (T, nx) x-phases are
    built on ``device`` (``phase_matrix``).
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
        self.E = phase_matrix(txa, np.fft.fftfreq(nx, 1.0 / nx),
                              device=device)                      # (T, nx)
        self.nfy = nfy
        self.T = txa.size
        self.w = w

    def _many_from_modes(self, c):
        """(B, nx, ny) complex modes -> (B, T) real values.  The fields ride
        the column axis of the fine y-transform and of each row gather."""
        B = c.shape[0]
        d = self.deconv_y * (self.nfy / (self.nx * self.ny))
        D = (c * d).permute(2, 0, 1).reshape(self.ny, B * self.nx)
        # the (ny + 1) // 2 modes k >= 0 in front, k < 0 at the end (see
        # _pad_modes: ipde_tpu moves k = (ny - 1) / 2 of an odd ny to the end)
        py = (self.ny + 1) // 2
        ry = self.ny - py
        P = D.new_zeros((self.nfy, B * self.nx))
        P[:py] = D[:py]
        P[self.nfy - ry:] = D[py:]
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
    with the (T, ny) and (T, nx) phase matrices built once on ``device`` in
    complex128 (``phase_matrix``: the same angles as ipde_tpu's, their cos
    and sin within an ulp or two of its host values).
    Many fields go through in chunks whose (T, B nx) complex temporaries
    stay under ``max_temp_bytes`` (ipde_tpu's memory guard ignores the
    number of fields).
    """

    #: bytes the (T, B nx) complex128 temporaries of one chunk of B fields
    #: may take (at least one field per chunk)
    max_temp_bytes = 1 << 29

    def __init__(self, nx: int, ny: int, tx, ty, x_offset: float = 0.0,
                 y_offset: float = 0.0, *, device):
        self.nx, self.ny = nx, ny
        txa = np.asarray(tx, np.float64).ravel() - x_offset
        tya = np.asarray(ty, np.float64).ravel() - y_offset
        kxn = np.fft.fftfreq(nx, 1.0 / nx)
        kyn = np.fft.fftfreq(ny, 1.0 / ny)
        self.T = txa.size
        self.EY = phase_matrix(tya, kyn, device=device)  # (T, ny)
        self.EX = phase_matrix(txa, kxn, device=device)  # (T, nx)
        self.ikx = torch.as_tensor(1j * kxn, dtype=torch.complex128,
                                   device=device)
        self.iky = torch.as_tensor(1j * kyn, dtype=torch.complex128,
                                   device=device)

    def _chunks(self, c):
        """(B, nx, ny) modes -> [(ny, b nx) column blocks, one per chunk of
        b fields], each with per-field column groups."""
        step = max(1, self.max_temp_bytes // (16 * self.T * self.nx))
        return [part.permute(2, 0, 1).reshape(self.ny, -1)
                for part in torch.split(c, step)]

    def _sum_x(self, g, EX):
        """Re sum_x g[t, b, x] EX[t, x] -> (b, T); g (T, b nx)."""
        g = g.reshape(self.T, -1, self.nx)
        return torch.einsum("tbx,tx->bt", g, EX).real

    def _many_from_modes(self, c):
        """(B, nx, ny) complex modes -> (B, T) real values."""
        return torch.cat([self._sum_x(self.EY @ C, self.EX)
                          for C in self._chunks(c)]) / (self.nx * self.ny)

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
        parts = []
        for C in self._chunks(c if batched else c[None]):
            g = self.EY @ C
            dg = (self.EY * self.iky) @ C
            parts.append((self._sum_x(g, self.EX),
                          self._sum_x(g, self.EX * self.ikx),
                          self._sum_x(dg, self.EX)))
        norm = 1.0 / (self.nx * self.ny)
        val, ddx, ddy = (torch.cat(p) * norm for p in zip(*parts))
        if batched:
            return val, ddx, ddy
        return val[0], ddx[0], ddy[0]

    def __call__(self, f):
        """f: real (nx, ny) or (B, nx, ny) grid values."""
        if f.dim() == 3:
            return self._many_from_modes(torch.fft.fft2(f))
        return self._many_from_modes(torch.fft.fft2(f)[None])[0]


def nufft2d2_exact(c: torch.Tensor, tx, ty) -> torch.Tensor:
    """Direct (exact) evaluation Re sum_k C_k e^{i k.x} / (nx ny) at the
    targets, on the device of c; O(T nx ny), for validation and small mode
    grids."""
    nx, ny = c.shape[-2:]
    dev = c.device
    kx = torch.as_tensor(np.fft.fftfreq(nx, 1.0 / nx), device=dev)
    ky = torch.as_tensor(np.fft.fftfreq(ny, 1.0 / ny), device=dev)
    tx = torch.as_tensor(np.asarray(tx, np.float64).ravel(), device=dev)
    ty = torch.as_tensor(np.asarray(ty, np.float64).ravel(), device=dev)
    # G[t, kx] = sum_ky C[kx, ky] e^{i ky ty}
    g = torch.exp(1j * ty[:, None] * ky[None, :]) @ c.T
    ex = torch.exp(1j * tx[:, None] * kx[None, :])
    return (ex * g).sum(dim=1).real / (nx * ny)


# ---------------------------------------------------------------------------
# periodic polynomial (Lagrange) interpolation to fixed targets
# ---------------------------------------------------------------------------

class PolyInterpolator2D:
    """k-th order Lagrange stencil interpolation on a periodic uniform grid
    (ipde_tpu.ops.interp.PolyInterpolator2D; reference:
    ipde/ebdy_collection.py:602, fast_interp.interp2d).  Stencil indices and
    weights are built on the host; the apply is one gather and a small
    einsum on ``device``."""

    def __init__(self, x0, y0, xh, yh, nx, ny, tx, ty, order: int = 7, *,
                 device):
        tx = (np.asarray(tx, np.float64).ravel() - x0) / xh
        ty = (np.asarray(ty, np.float64).ravel() - y0) / yh
        k = order
        half = (k - 1) // 2
        jx = np.floor(tx).astype(np.int64) - half
        jy = np.floor(ty).astype(np.int64) - half
        offs = np.arange(k)
        px = jx[:, None] + offs
        py = jy[:, None] + offs
        wx = _lagrange_weights(tx[:, None] - px)
        wy = _lagrange_weights(ty[:, None] - py)
        flat = (np.mod(px, nx)[:, :, None] * ny + np.mod(py, ny)[:, None, :])
        self.flat_idx = torch.as_tensor(flat.reshape(tx.size, k * k),
                                        device=device)
        self.wx = torch.as_tensor(wx, device=device)
        self.wy = torch.as_tensor(wy, device=device)
        self.k = k
        self.T = tx.size

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        patches = f.reshape(-1)[self.flat_idx].reshape(self.T, self.k, self.k)
        return torch.einsum("tp,tq,tpq->t", self.wx, self.wy, patches)


def _lagrange_weights(d):
    """Lagrange basis weights for nodes at integer offsets given distances d
    (T, k) where d[:, j] = t - node_j; nodes are 0..k-1 shifted."""
    T, k = d.shape
    w = np.ones((T, k))
    for j in range(k):
        for m in range(k):
            if m != j:
                w[:, j] *= d[:, m] / (d[:, m] - d[:, j])
    return w


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
    elif nx <= 64:
        cls = HybridInterp2D
    elif T * 8 <= nx * ny:
        # few targets on a big grid: a wider window for less upsampling
        cls = PeriodicInterpolator2D
        kw = {"sigma": 1.25, "w": 24}
    else:
        cls = PeriodicInterpolator2D
    print(f"[ipde_tpu_torch] interpolator: {nx}x{ny} modes, {T} targets "
          f"-> {cls.__name__}", flush=True)
    return cls(nx, ny, tx, ty, x_offset=x_offset, y_offset=y_offset,
               device=device, **kw)
