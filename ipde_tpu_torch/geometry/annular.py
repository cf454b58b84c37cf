"""Annular (Chebyshev x Fourier) geometry for the boundary-fitted strip.

TPU-native rework of the reference's ApproximateAnnularGeometry /
RealAnnularGeometry (reference: ipde/annular/annular.py:52-108,
annular_full.py).  One convention everywhere:

  * radial nodes are ASCENDING first-kind Chebyshev points on [lb, ub],
    where (lb, ub) = (-width, 0) for interior problems and (0, width) for
    exterior problems -- i.e. exactly the embedded boundary's radial grid,
    measured from the generating curve along its outward normal,
  * the metric is psi(r, t) = speed(t) * (1 + r * curvature(t)) of the
    GENERATING curve (equivalent to the reference's outer-curve form, since
    normal-offset curves satisfy s_o(1 + r_o k_o) = s(1 + r k)),
  * all Fourier modes are kept (the reference's annular_full lineage); the
    tangential grid has n points, rfft modes nk = n//2 + 1.

Host-side numpy; device mirrors are created by the solvers.
"""

from __future__ import annotations

import numpy as np

from ipde_tpu_torch.utils.cheb import ChebyshevOperators, get_chebyshev_nodes


class AnnularGeometry:
    """Operator set + circle-approximation metric for one annulus."""

    def __init__(self, n: int, M: int, lb: float, ub: float, approx_r: float):
        self.n = n
        self.M = M
        self.lb = lb
        self.ub = ub
        self.width = ub - lb
        self.nk = n // 2 + 1
        self.approx_r = approx_r
        _, self.rv0, self.rat = get_chebyshev_nodes(lb, ub, M)
        _, self.rv1, _ = get_chebyshev_nodes(lb, ub, M - 1)
        _, self.rv2, _ = get_chebyshev_nodes(lb, ub, M - 2)
        self.CO = ChebyshevOperators(M, self.rat)
        # circle approximation: radius approx_r + r
        self.approx_psi0 = approx_r + self.rv0
        self.approx_psi1 = approx_r + self.rv1
        self.approx_psi2 = approx_r + self.rv2
        self.modes = np.arange(self.nk, dtype=np.float64)

    def fits(self, ebdy) -> bool:
        """Whether an annular solver built for this geometry can serve the
        embedded boundary ``ebdy`` (helper reuse under moving boundaries):
        the same (n, M) and radial bounds, and a radius within 0.8-1.25 of
        the one its circle-approximation preconditioner was built for
        (reference analogue: ipde/solvers/multi_boundary/
        modified_helmholtz.py:13-39)."""
        return ((self.n, self.M) == (ebdy.bdy.N, ebdy.M)
                and abs(self.lb - ebdy.lb) <= 1e-12
                and abs(self.ub - ebdy.ub) <= 1e-12
                and 0.8 <= ebdy.approximate_radius / self.approx_r <= 1.25)


class AnnularMetric:
    """True metric psi = speed * (1 + r * curvature) on the three radial grids.

    speed/curvature are those of the generating curve (n samples).
    Reference analogue: RealAnnularGeometry (ipde/annular/annular.py:87-108).
    """

    def __init__(self, speed: np.ndarray, curvature: np.ndarray,
                 geom: AnnularGeometry):
        speed = np.asarray(speed, np.float64)
        curvature = np.asarray(curvature, np.float64)
        self.psi0 = speed * (1.0 + geom.rv0[:, None] * curvature)
        self.psi1 = speed * (1.0 + geom.rv1[:, None] * curvature)
        self.psi2 = speed * (1.0 + geom.rv2[:, None] * curvature)
        self.inv_psi0 = 1.0 / self.psi0
        self.inv_psi1 = 1.0 / self.psi1
        self.inv_psi2 = 1.0 / self.psi2
        # quantities for the Stokes strip solver (d/dt of curvature terms)
        k = np.fft.fftfreq(curvature.shape[0], 1.0 / curvature.shape[0])
        self.dt_curvature = np.fft.ifft(np.fft.fft(curvature) * 1j * k).real
        self.speed = speed
        self.curvature = curvature
