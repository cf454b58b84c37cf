"""Spectral closed curves: the boundary type of the framework.

Replaces the reference's external pybie2d ``Global_Smooth_Boundary`` surface
(x, y, N, t, dt, normal_x/y, tangent_x/y, speed, curvature, weights; see
SURVEY.md section 2.2).  A curve is N equispaced samples in parameter
t in [0, 2pi); all differential geometry comes from the FFT of (x, y).

Everything here is host-side numpy (geometry setup is precompute); torch
mirrors of the arrays a device kernel needs are created lazily by ``dev``.
"""

from __future__ import annotations

import numpy as np


class BoundaryCurve:
    """A smooth closed curve sampled at N equispaced parameter values.

    Parametrization is assumed counterclockwise; the stored normal points
    OUTWARD (right of the tangent direction).
    """

    # ``dev``'s mirrors are a cache of the host arrays, filled by whichever
    # setup asks first: utils/planify.py does not take them for plans (a
    # solve path keeps its own device copies, made with its object)
    _plan_caches = ("_dev",)

    def __init__(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        assert x.ndim == 1 and x.shape == y.shape
        self.x = x
        self.y = y
        self.N = x.size
        self.dt = 2.0 * np.pi / self.N
        self.t = np.arange(self.N) * self.dt
        self.k = np.fft.fftfreq(self.N, 1.0 / self.N)
        # spectral derivatives of the position
        self.xh = np.fft.fft(x)
        self.yh = np.fft.fft(y)
        ik = 1j * self.k
        self.xp = np.fft.ifft(self.xh * ik).real
        self.yp = np.fft.ifft(self.yh * ik).real
        self.xpp = np.fft.ifft(self.xh * ik * ik).real
        self.ypp = np.fft.ifft(self.yh * ik * ik).real
        self.speed = np.hypot(self.xp, self.yp)
        self.tangent_x = self.xp / self.speed
        self.tangent_y = self.yp / self.speed
        self.normal_x = self.tangent_y
        self.normal_y = -self.tangent_x
        self.curvature = (self.xp * self.ypp - self.yp * self.xpp) / self.speed**3
        self.weights = self.speed * self.dt
        # complex position (host convenience)
        self.c = x + 1j * y

    # -- factories -----------------------------------------------------------
    @classmethod
    def from_c(cls, c: np.ndarray) -> "BoundaryCurve":
        return cls(np.real(c), np.imag(c))

    # -- device mirrors --------------------------------------------------------
    def dev(self, device) -> dict:
        """float64 torch mirrors, on ``device``, of the arrays the layer
        potential kernels and the device-built forms (ops/forms_dev.py)
        consume; cached per device."""
        import torch
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dev", {})
        d = cache.get(device)
        if d is None:
            d = {name: torch.as_tensor(getattr(self, name), dtype=torch.float64,
                                       device=device).contiguous()
                 for name in ("x", "y", "weights", "normal_x", "normal_y",
                              "tangent_x", "tangent_y", "speed", "curvature",
                              "t")}
            cache[device] = d
        return d

    # -- evaluation at arbitrary parameters -----------------------------------
    def eval_position(self, t: np.ndarray):
        """(x, y) at arbitrary parameter values t via the Fourier series."""
        ph = np.exp(1j * np.outer(t, self.k))
        x = (ph @ self.xh).real / self.N
        y = (ph @ self.yh).real / self.N
        return x, y

    def eval_derivative(self, t: np.ndarray, order: int = 1):
        ik = (1j * self.k) ** order
        ph = np.exp(1j * np.outer(t, self.k))
        x = (ph @ (self.xh * ik)).real / self.N
        y = (ph @ (self.yh * ik)).real / self.N
        return x, y

    # -- derived curves -------------------------------------------------------
    def normal_offset(self, dist: float) -> "BoundaryCurve":
        """Curve displaced by dist along the outward normal."""
        return BoundaryCurve(self.x + dist * self.normal_x,
                             self.y + dist * self.normal_y)

    def complex_offset(self, a: float) -> "BoundaryCurve":
        """Analytic continuation shift c(t - i a): a>0 moves the curve
        outward (for counterclockwise curves) with conformal distance a.

        This is the 'complex' shift_type of the reference's QFS machinery
        (SURVEY.md section 2.2, qfs row): the image of the circle |w|=e^a
        under the curve's analytic extension, which keeps shifted curves
        smooth even where large normal offsets would self-intersect.
        """
        decay = np.exp(a * self.k)  # modes k>0 amplified: c(t) ~ sum c_k e^{ikt}
        ch = np.fft.fft(self.c)
        # zero the numerical-noise modes BEFORE amplification: on upsampled
        # curves the modes above the original band are exact zeros refilled
        # with ~1e-16 fft roundoff, and e^{a k} raises them up to ~1e6x --
        # measured 5e-12 near-Nyquist junk in QFS source coordinates, which
        # breaks the spectral decay the subsampled radial quadrature
        # (ops/stratified.py) relies on
        floor = np.abs(ch).max() * 1e-14
        ch = np.where(np.abs(ch) <= floor, 0.0, ch) * decay
        cnew = np.fft.ifft(ch)
        return BoundaryCurve(np.real(cnew), np.imag(cnew))

    def resampled(self, N_new: int) -> "BoundaryCurve":
        """Fourier up/down-sampling to N_new points."""
        xh = _resample_modes(self.xh, self.N, N_new)
        yh = _resample_modes(self.yh, self.N, N_new)
        x = np.fft.ifft(xh).real * (N_new / self.N)
        y = np.fft.ifft(yh).real * (N_new / self.N)
        return BoundaryCurve(x, y)

    def max_h(self) -> float:
        return float((self.speed * self.dt).max())

    def min_h(self) -> float:
        return float((self.speed * self.dt).min())

    def stacked(self) -> np.ndarray:
        return np.stack([self.x, self.y])


def _resample_modes(fh: np.ndarray, n_old: int, n_new: int) -> np.ndarray:
    out = np.zeros(n_new, dtype=complex)
    m = min(n_old, n_new)
    h = m // 2
    out[:h] = fh[:h]
    out[-h:] = fh[-h:]
    if n_new > n_old and n_old % 2 == 0:
        # split the old Nyquist mode symmetrically; the ``out[-h:]`` copy
        # above already placed the FULL coefficient fh[h] at out[-h], so
        # both halves must be SET (not accumulated)
        out[h] = 0.5 * fh[h]
        out[-h] = 0.5 * fh[h]
    return out


def arc_length_parameterize(x: np.ndarray, y: np.ndarray, tol: float = 1e-13,
                            max_iter: int = 50, return_t: bool = False):
    """Resample a closed curve at (spectrally) equal arclength increments.

    Newton iteration on the Fourier representation of cumulative arclength
    (reference analogue: personal_utilities.arc_length_parameterize used at
    ipde/advection/fe_advector.py:44).
    """
    crv = BoundaryCurve(x, y)
    N = crv.N
    # cumulative arclength via spectral antiderivative of speed
    sh = np.fft.fft(crv.speed)
    L = sh[0].real * crv.dt  # total length
    target = np.arange(N) / N * L
    # s(t) = (L / 2pi) t + periodic part
    k = crv.k.copy()
    k[0] = 1.0
    per = np.fft.ifft(np.where(crv.k == 0, 0.0, sh / (1j * k))).real
    per -= per[0]

    def s_of_t(t):
        ph = np.exp(1j * np.outer(t, crv.k))
        p = (ph @ np.fft.fft(per)).real / N
        return (L / (2 * np.pi)) * t + p - ((L / (2 * np.pi)) * 0 + per[0])

    def speed_of_t(t):
        ph = np.exp(1j * np.outer(t, crv.k))
        return (ph @ sh).real / N

    t = crv.t.copy()
    for _ in range(max_iter):
        f = s_of_t(t) - target
        t = t - f / speed_of_t(t)
        if np.abs(f).max() < tol * L:
            break
    xn, yn = crv.eval_position(t)
    out = BoundaryCurve(xn, yn)
    return (out, t) if return_t else out


# ---------------------------------------------------------------------------
# standard test shapes (same families the reference examples use via pybie2d)
# ---------------------------------------------------------------------------

def star(N: int, x: float = 0.0, y: float = 0.0, r: float = 1.0,
         a: float = 0.5, f: int = 3, rot: float = 0.0) -> BoundaryCurve:
    """Smooth star: radius r(1 + a cos(f(t - rot))) about (x, y)."""
    t = np.arange(N) * 2.0 * np.pi / N
    c = (x + 1j * y) + r * (1.0 + a * np.cos(f * (t - rot))) * np.exp(1j * t)
    return BoundaryCurve.from_c(c)


def circle(N: int, x: float = 0.0, y: float = 0.0, r: float = 1.0) -> BoundaryCurve:
    t = np.arange(N) * 2.0 * np.pi / N
    c = (x + 1j * y) + r * np.exp(1j * t)
    return BoundaryCurve.from_c(c)


def squished_circle(N: int, x: float = 0.0, y: float = 0.0, r: float = 1.0,
                    b: float = 0.9, rot: float = 0.0) -> BoundaryCurve:
    """Ellipse-like squished circle with aspect parameter b in (0, 1]."""
    t = np.arange(N) * 2.0 * np.pi / N
    xs = r * np.cos(t)
    ys = r * b * np.sin(t)
    cr, sr = np.cos(rot), np.sin(rot)
    return BoundaryCurve(x + cr * xs - sr * ys, y + sr * xs + cr * ys)
