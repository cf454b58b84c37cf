"""Slepian (DPSS) mollifier: regularized step and bump functions.

The geometry layer rolls off the inhomogeneity through the annular strip with
a prolate-spheroidal (DPSS) window: ``bump`` is the window itself, ``step``
its normalized antiderivative (0 at x<=-1, 1 at x>=+1).  The reference ships
a 14.8k-line precomputed Chebyshev coefficient table
(reference: ipde/slepian/heaviside_coefficients.py, constructed by
ipde/slepian/construct_coefficients.py); we regenerate the same functions at
setup time from scipy's DPSS window and cache Chebyshev fits per slepian_r.

Evaluation is vectorized numpy (host, geometry setup) via
Clenshaw on even-Chebyshev coefficients.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal.windows import dpss


@functools.lru_cache(maxsize=32)
def _slepian_tables(r: float, N: int = 4000):
    """Chebyshev coefficient tables (even part) for bump and (step-1/2)/x."""
    x = np.linspace(-1.0, 1.0, N)
    w = dpss(N, 0.25 * float(r))
    w = w / w.max()
    # antiderivative via high-order quadrature on the fine grid (composite
    # Simpson is plenty at N=4000 since the window is analytic)
    from scipy.integrate import cumulative_simpson
    s = cumulative_simpson(w, x=x, initial=0.0)
    s /= s[-1]
    # Chebyshev fits; bump is even, (step - 1/2) is odd -> fit (step-1/2)/x
    deg = 256
    xc = np.cos(np.pi * (np.arange(deg) + 0.5) / deg)
    bump_v = np.interp(xc, x, w)
    step_v = np.interp(xc, x, s)
    # refine with spline interpolation for spectral-grade accuracy
    from scipy.interpolate import InterpolatedUnivariateSpline
    bump_sp = InterpolatedUnivariateSpline(x, w, k=5)
    step_sp = InterpolatedUnivariateSpline(x, s, k=5)
    bump_v = bump_sp(xc)
    step_v = step_sp(xc)
    cb = np.polynomial.chebyshev.chebfit(xc, bump_v, deg - 1)
    cs = np.polynomial.chebyshev.chebfit(xc, step_v, deg - 1)
    # truncate at 1e-15
    def trunc(c):
        mag = np.abs(c)
        keep = np.nonzero(mag > 1e-15 * mag.max())[0]
        return c[: keep[-1] + 1] if keep.size else c[:1]
    return trunc(cb), trunc(cs)


class SlepianMollifier:
    """step/bump pair with transition on [-1, 1].

    reference semantics: ipde/slepian/chebeval_bump_step.py:1-44 and
    function_generator_bump_step.py:7-56.
    """

    def __init__(self, r: float):
        self.r = r
        self.bump_c, self.step_c = _slepian_tables(float(r))

    def bump(self, x):
        x = np.asarray(x, np.float64)
        out = np.zeros_like(x)
        good = (x > -1.0) & (x < 1.0)
        out[good] = np.polynomial.chebyshev.chebval(x[good], self.bump_c)
        return out

    def step(self, x):
        x = np.asarray(x, np.float64)
        out = np.zeros_like(x)
        good = (x > -1.0) & (x < 1.0)
        out[good] = np.polynomial.chebyshev.chebval(x[good], self.step_c)
        out[x >= 1.0] = 1.0
        return np.clip(out, 0.0, 1.0)
