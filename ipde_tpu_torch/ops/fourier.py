"""Fourier transforms and spectral operators on torch.fft (complex128).

The box solve's 2D transform (``FourierPlan2D``, with batched stacks of
fields, and the half-spectrum forms the free-space grid evaluators use),
the 1D last-axis derivative (``FourierPlan1D``) and the annular solvers'
tangential plan (``tan_rfft`` / ``tan_irfft`` / ``tan_deriv`` along the last
axis) with the frequency helpers.  Reference semantics:
ipde/utilities.py:78-124 (Nyquist handling).
"""

from __future__ import annotations

import numpy as np
import torch


def rfftfreq_np(n: int, h: float = 1.0) -> np.ndarray:
    return np.fft.rfftfreq(n, h)


def fftfreq_np(n: int, h: float = 1.0) -> np.ndarray:
    return np.fft.fftfreq(n, h)


def spectral_diff_matrix_np(n: int, order: int = 1,
                            length: float = 2.0 * np.pi) -> np.ndarray:
    """Real n x n Fourier spectral differentiation matrix on a periodic grid,
    D = ifft(diag((ik)^order) fft(I)).real, with the Nyquist mode zeroed for
    odd derivative orders."""
    k = np.fft.fftfreq(n, 1.0 / n) * (2.0 * np.pi / length)
    ik = (1j * k) ** order
    if order % 2 == 1 and n % 2 == 0:
        ik[n // 2] = 0.0
    return np.fft.ifft(ik[:, None] * np.fft.fft(np.eye(n), axis=0),
                       axis=0).real


class FourierPlan1D:
    """Spectral derivative along the LAST axis of a real tensor (period
    ``length``) with the Nyquist mode zeroed: the real differentiation
    circulant of ipde_tpu.ops.fourier.FourierPlan1D, on torch.fft."""

    def __init__(self, n: int, length: float = 2.0 * np.pi, *, device):
        self.n = n
        self.tan = TanPlan(n, device, length)

    def tderiv(self, x: torch.Tensor) -> torch.Tensor:
        """d/dt along the last axis."""
        return tan_deriv(x, self.tan)


class FourierPlan2D:
    """2D DFT of real (nx, ny) fields: complex128 modes in fftfreq order,
    unnormalized (numpy's convention).  A leading batch dimension
    transforms a stack of fields in one call."""

    def __init__(self, nx: int, ny: int):
        self.nx, self.ny = nx, ny

    def fft2(self, x: torch.Tensor) -> torch.Tensor:
        """Modes of a real (..., nx, ny) field."""
        return torch.fft.fft2(x)

    def ifft2_real(self, c: torch.Tensor) -> torch.Tensor:
        """Real part of the inverse 2D DFT of c."""
        return torch.fft.ifft2(c).real

    def fft2_stack(self, xs) -> torch.Tensor:
        """Modes (B, nx, ny) of B same-shape real fields, one batched
        transform."""
        return torch.fft.fft2(torch.stack(list(xs)))

    def ifft2_real_stack(self, cs) -> torch.Tensor:
        """Real parts (B, nx, ny) of the inverse transforms of B spectra,
        one batched transform."""
        return torch.fft.ifft2(torch.stack(list(cs))).real

    def rfft2(self, x: torch.Tensor) -> torch.Tensor:
        """Half spectrum (..., nx//2 + 1, ny) of a real (..., mx, my) field,
        mx <= nx and my <= ny, the missing tail taken as zeros (the padded
        free-space evaluators spread their sources into a prefix block).
        The FIRST axis is the halved one, rows kx = 0..nx/2, as in
        ipde_tpu.ops.fourier.FourierPlan2D.rfft2 (torch.fft.rfft2 halves
        the last): the evaluators' symbols are laid out for it.  A leading
        batch dimension transforms a stack of fields in one call (ipde_tpu's
        rfft2_stack)."""
        return torch.fft.fft(torch.fft.rfft(x, n=self.nx, dim=-2), n=self.ny,
                             dim=-1)

    def irfft2_real_corner(self, c: torch.Tensor, nx_out: int, ny_out: int,
                           nx0: int = 0, ny0: int = 0) -> torch.Tensor:
        """The window [nx0:nx0 + nx_out, ny0:ny0 + ny_out] of the real
        (..., nx, ny) field whose ``rfft2`` half spectrum is c; the second
        pass runs on the ny_out columns of the window only.  Batched like
        rfft2 (ipde_tpu's irfft2_real_corner_stack)."""
        z = torch.fft.ifft(c, dim=-1)[..., ny0:ny0 + ny_out]
        return torch.fft.irfft(z, n=self.nx, dim=-2)[..., nx0:nx0 + nx_out, :]


class TanPlan:
    """Last-axis real FFT plan: derivative wavenumbers with the Nyquist mode
    zeroed (odd-derivative convention), on one device."""

    def __init__(self, n: int, device, length: float = 2.0 * np.pi):
        self.n = n
        self.nk = n // 2 + 1
        k = rfftfreq_np(n, length / (2.0 * np.pi * n)).copy()
        if n % 2 == 0:
            k[-1] = 0.0
        self.ik = torch.as_tensor(1j * k, dtype=torch.complex128,
                                  device=device)


def make_tan_plan(n: int, device, length: float = 2.0 * np.pi) -> TanPlan:
    return TanPlan(n, device, length)


def tan_rfft(x: torch.Tensor, tp: TanPlan) -> torch.Tensor:
    """rfft along the LAST axis of real x (m, n) -> complex (m, nk)."""
    return torch.fft.rfft(x, dim=-1)


def tan_irfft(c: torch.Tensor, tp: TanPlan) -> torch.Tensor:
    """Inverse of tan_rfft: complex (m, nk) -> real (m, n); the imaginary
    parts of the zero and Nyquist modes are ignored."""
    return torch.fft.irfft(c, n=tp.n, dim=-1)


def tan_deriv(x: torch.Tensor, tp: TanPlan) -> torch.Tensor:
    """d/dt along the last axis via rfft -> ik -> irfft."""
    return tan_irfft(tan_rfft(x, tp) * tp.ik, tp)
