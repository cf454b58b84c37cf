"""EmbeddedBoundary: one smooth boundary + its boundary-fitted radial grid.

Redesign of the reference's EmbeddedBoundary (reference:
ipde/embedded_boundary.py:55-557 and the _tr lineage).  Host-side numpy for
all geometry-static precompute; the solvers upload what they need.

Coordinate conventions (one lineage, used consistently everywhere):
  * the curve is counterclockwise with OUTWARD normal,
  * the signed radial coordinate r is the displacement along the outward
    normal: interior problems use r in [-width, 0] (interface at -width,
    boundary at 0), exterior problems r in [0, width],
  * radial nodes are ascending first-kind Chebyshev points (row 0 = lowest r).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ipde_tpu_torch.geometry.coords import grid_points_near_curve
from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.geometry.grid import Grid
from ipde_tpu_torch.ops.slepian import SlepianMollifier
from ipde_tpu_torch.utils.cheb import (chebvander, chebyshev_differentiation_matrix,
                                 fejer_1_weights, get_chebyshev_nodes)
from ipde_tpu_torch.utils.profiling import spanned


class EmbeddedBoundary:
    @spanned("geometry.boundary")
    def __init__(self, bdy: BoundaryCurve, interior: bool, M: int, h: float,
                 pad_zone: float = 0.0, slepian_r: Optional[float] = None,
                 coordinate_tolerance: float = 1e-14,
                 qfs_tolerance: float = 1e-12,
                 qfs_source_shift: Optional[float] = None):
        self.bdy = bdy
        self.interior = bool(interior)
        self.M = int(M)
        self.h = float(h)
        self.pad_zone = pad_zone
        self.coordinate_tolerance = coordinate_tolerance
        self.qfs_tolerance = qfs_tolerance
        self.qfs_source_shift = qfs_source_shift
        self.slepian_r = slepian_r if slepian_r is not None else 2 * M
        self.mollifier = SlepianMollifier(self.slepian_r)
        self.radial_width = self.M * self.h
        self.heaviside_width = self.radial_width - self.pad_zone * self.h
        # the boundary-fitted map x = c(t) + r n(t) degenerates where
        # 1 + r*kappa <= 0; require a healthy margin or the annular
        # operator becomes singular (GMRES then stalls mysteriously)
        lb_chk, ub_chk = ((-self.radial_width, 0.0) if self.interior
                          else (0.0, self.radial_width))
        min_jac = min(float((1.0 + lb_chk * bdy.curvature).min()),
                      float((1.0 + ub_chk * bdy.curvature).min()))
        self.min_annulus_jacobian = min_jac
        if min_jac <= 0.05:
            import warnings
            warnings.warn(
                f"radial width {self.radial_width:.3g} is at/beyond the "
                f"boundary's curvature radius (min annulus Jacobian "
                f"{min_jac:.3f}); the annular solve may stall unless the "
                f"boundary is finely resolved. Consider M*h < "
                f"~{0.8 / np.abs(bdy.curvature).max():.3g}.")
        self._generate_radial_grid()
        self._generate_qfs_source_curves()
        self.registration = None

    # ------------------------------------------------------------------
    # radial grid
    # ------------------------------------------------------------------
    def _generate_radial_grid(self):
        bdy = self.bdy
        w = self.radial_width
        sign = -1.0 if self.interior else 1.0
        self.interface = bdy.normal_offset(sign * w)
        lb, ub = (-w, 0.0) if self.interior else (0.0, w)
        self.lb, self.ub = lb, ub
        rc, rv, rat = get_chebyshev_nodes(lb, ub, self.M)
        self.radial_rv = rv
        self.radial_rat = rat
        self.radial_tv = bdy.t
        self.radial_r = np.broadcast_to(rv[:, None], (self.M, bdy.N)).copy()
        self.radial_t = np.broadcast_to(bdy.t[None, :], (self.M, bdy.N)).copy()
        self.radial_x = bdy.x + self.radial_r * bdy.normal_x
        self.radial_y = bdy.y + self.radial_r * bdy.normal_y
        self.radial_shape = (self.M, bdy.N)
        # metric and quadrature
        self.radial_speed = bdy.speed * (1.0 + bdy.curvature * self.radial_r)
        self.inverse_radial_speed = 1.0 / self.radial_speed
        wq = fejer_1_weights(self.M)
        self.radial_quadrature_weights = (bdy.dt * wq[:, None] * (w / 2.0)
                                          * self.radial_speed)
        # radial Chebyshev differentiation + edge interpolation rows
        V0 = chebvander(rc, self.M - 1)
        VI0 = np.linalg.inv(V0)
        self.D00 = chebyshev_differentiation_matrix(self.M, rat)
        row_ub = (chebvander(np.array([1.0]), self.M - 1) @ VI0)[0]
        row_lb = (chebvander(np.array([-1.0]), self.M - 1) @ VI0)[0]
        if self.interior:
            self.interp_f_to_bdy = row_ub          # r = 0
            self.interp_f_to_interface = row_lb    # r = -w
        else:
            self.interp_f_to_bdy = row_lb          # r = 0
            self.interp_f_to_interface = row_ub    # r = w
        self.interp_dn_to_bdy = self.interp_f_to_bdy @ self.D00
        self.interp_dn2_to_bdy = self.interp_dn_to_bdy @ self.D00
        self.interp_dn_to_interface = self.interp_f_to_interface @ self.D00
        # approximate radius (for the annular preconditioner)
        cx, cy = bdy.x.mean(), bdy.y.mean()
        self.bdy_centroid = (cx, cy)
        self.approximate_radius = float(np.hypot(bdy.x - cx, bdy.y - cy).mean())
        # radial rolloff: 1 near the boundary, 0 at the interface side
        self.radial_cutoff = self._step_profile(self.radial_rv)

    def _step_profile(self, r):
        """Regularized Heaviside in r: 1 at the boundary (r=0), rolling to 0
        at the far (interface) edge of the heaviside width."""
        hw = self.heaviside_width
        if self.interior:
            arg = (r + hw) / hw * 2.0 - 1.0     # r in [-hw, 0] -> [-1, 1]
        else:
            arg = (hw - r) / hw * 2.0 - 1.0     # r in [0, hw] -> [1, -1]
        return self.mollifier.step(arg)

    # ------------------------------------------------------------------
    # grid registration
    # ------------------------------------------------------------------
    @spanned("geometry.coords")
    def register_grid(self, grid: Grid, danger_zone_distance: float = 0.0,
                      verbose: bool = False):
        """Locate grid points inside the annulus and compute their (t, r).

        Returns and caches an EBRegistration. Reference analogue:
        ipde/embedded_boundary.py:185-269.
        """
        ddd = danger_zone_distance
        ix, iy, t, r = grid_points_near_curve(
            self.bdy, grid.xv, grid.yv, self.radial_width + ddd,
            newton_tol=self.coordinate_tolerance)
        if self.interior:
            in_ann = (r <= 0.0) & (r >= -self.radial_width)
        else:
            in_ann = (r >= 0.0) & (r <= self.radial_width)
        reg = EBRegistration(
            grid=grid,
            near_ix=ix, near_iy=iy, near_t=t, near_r=r,
            ia_ix=ix[in_ann], ia_iy=iy[in_ann],
            ia_t=t[in_ann], ia_r=r[in_ann],
        )
        # rolloff (grid -> radial handoff): 1 - step, i.e. 1 deep in the
        # physical region, rolling to 0 approaching the boundary
        reg.grid_to_radial_step = 1.0 - self._step_profile(reg.ia_r)
        # danger zone bookkeeping (moving-boundary support)
        if ddd > 0.0:
            if self.interior:
                idz = (r <= ddd) & (r >= -self.radial_width - ddd)
            else:
                idz = (r >= -ddd) & (r <= self.radial_width + ddd)
            reg.dz_ix, reg.dz_iy = ix[idz], iy[idz]
            reg.dz_t, reg.dz_r = t[idz], r[idz]
        self.registration = reg
        return reg

    # ------------------------------------------------------------------
    # transforms between the radial grid and other representations
    # ------------------------------------------------------------------
    def nufft_theta(self, r):
        """Map radial coordinate(s) to the Chebyshev-reflection angle in
        [0, pi]: theta = arccos(-x_unscaled)."""
        xc = (np.asarray(r) - self.lb) / self.radial_rat - 1.0
        return np.arccos(-np.clip(xc, -1.0, 1.0))

    def interpolate_radial_to_boundary(self, fr):
        return self.interp_f_to_bdy @ fr

    def interpolate_radial_to_interface(self, fr):
        return self.interp_f_to_interface @ fr

    def interpolate_radial_to_boundary_normal_derivative(self, fr):
        return self.interp_dn_to_bdy @ fr

    def interpolate_radial_to_interface_normal_derivative(self, fr):
        return self.interp_dn_to_interface @ fr

    # ------------------------------------------------------------------
    # QFS source curves (kernel-independent geometry; kernel-specific maps
    # are built by ipde_tpu.qfs on top of these)
    # ------------------------------------------------------------------
    def _generate_qfs_source_curves(self):
        """Shifted source curves for effective (MFS-style) representations.

        For evaluating a field on the interior side of a curve, effective
        sources live on a curve shifted OUTWARD (away from the evaluation
        side), and vice versa.  Shifts use the analytic continuation
        c(t -+ i a) so narrow features stay smooth (reference: qfs package
        'complex' shift_type; SURVEY.md 2.2).  The shift is a few parameter
        grid spacings with 2x-upsampled sources: empirically (see
        tests/test_singular_qfs.py) alpha=3, upsampling=2 holds ~1e-12
        through the on-surface least-squares match.
        """
        self.qfs_upsampling = 3
        for name, curve in (("bdy", self.bdy), ("interface", self.interface)):
            a = self._qfs_shift_param(curve)
            fine = curve.resampled(self.qfs_upsampling * curve.N)
            setattr(self, f"{name}_qfs_upper", fine.complex_offset(+a))
            setattr(self, f"{name}_qfs_lower", fine.complex_offset(-a))

    def _qfs_shift_param(self, curve: BoundaryCurve) -> float:
        """Conformal shift distance, 1.5 parameter grid spacings.

        The shift sets the pinv amplification exp(shift * k): alpha = 3
        (round 1) gave QFS maps of norm ~3e6, whose TPU matmul roundoff
        (~1e-14 per row norm) floored solves at ~5e-8.  alpha = 1.5 with
        3x-upsampled sources keeps the naive source quadrature's
        evaluation tail at exp(-2 pi * shift/h_src) = exp(-9 pi) ~ 5e-13
        while cutting the map norm ~100x (and measurably IMPROVING the
        CPU-exact e2e error: better-conditioned least squares)."""
        if self.qfs_source_shift is not None:
            return self.qfs_source_shift
        return 1.5 * 2.0 * np.pi / curve.N

    def qfs_source_for_side(self, curve_name: str, interior_eval: bool,
                            alpha: Optional[float] = None):
        """Source curve for evaluating on the given side of bdy/interface.

        interior_eval=True -> targets inside the curve -> sources outside
        (the 'upper' complex offset moves outward for ccw curves).

        alpha overrides the default shift (in parameter grid spacings) for
        kernels that need a larger one -- the high-k Yukawa quadrature
        needs alpha ~ 2-3 while Laplace/Stokes prefer 1.5 (smaller QFS
        amplification; see _qfs_shift_param).  Curves are cached per
        (name, side, alpha)."""
        suffix = "upper" if interior_eval else "lower"
        if alpha is None or self.qfs_source_shift is not None:
            return getattr(self, f"{curve_name}_qfs_{suffix}")
        key = (curve_name, suffix, round(float(alpha), 6))
        cache = self.__dict__.setdefault("_qfs_curve_cache", {})
        if key not in cache:
            curve = self.bdy if curve_name == "bdy" else self.interface
            a = alpha * 2.0 * np.pi / curve.N
            fine = curve.resampled(self.qfs_upsampling * curve.N)
            cache[key] = fine.complex_offset(a if interior_eval else -a)
        return cache[key]

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    def radial_integral(self, fr):
        return float(np.sum(np.asarray(fr) * self.radial_cutoff[:, None]
                            * self.radial_quadrature_weights))

    def save(self) -> dict:
        return {
            "bx": self.bdy.x, "by": self.bdy.y, "interior": self.interior,
            "M": self.M, "h": self.h, "pad_zone": self.pad_zone,
            "slepian_r": self.slepian_r,
            "coordinate_tolerance": self.coordinate_tolerance,
            "qfs_tolerance": self.qfs_tolerance,
            "qfs_source_shift": self.qfs_source_shift,
        }

    def regenerate(self, bx: np.ndarray, by: np.ndarray) -> "EmbeddedBoundary":
        """New EmbeddedBoundary with a moved boundary, same parameters
        (reference: ipde/embedded_boundary.py:146-158)."""
        return EmbeddedBoundary(
            BoundaryCurve(bx.copy(), by.copy()), self.interior, self.M, self.h,
            pad_zone=self.pad_zone, slepian_r=self.slepian_r,
            coordinate_tolerance=self.coordinate_tolerance,
            qfs_tolerance=self.qfs_tolerance,
            qfs_source_shift=self.qfs_source_shift)


def load_embedded_boundary(d: dict) -> EmbeddedBoundary:
    return EmbeddedBoundary(
        BoundaryCurve(d["bx"], d["by"]), d["interior"], d["M"], d["h"],
        pad_zone=d.get("pad_zone", 0.0), slepian_r=d.get("slepian_r"),
        coordinate_tolerance=d.get("coordinate_tolerance", 1e-14),
        qfs_tolerance=d.get("qfs_tolerance", 1e-12),
        qfs_source_shift=d.get("qfs_source_shift"))


@dataclass
class EBRegistration:
    """Per-(boundary, grid) registration data (host numpy index sets)."""
    grid: Grid
    near_ix: np.ndarray
    near_iy: np.ndarray
    near_t: np.ndarray
    near_r: np.ndarray
    ia_ix: np.ndarray
    ia_iy: np.ndarray
    ia_t: np.ndarray
    ia_r: np.ndarray
    grid_to_radial_step: np.ndarray = None
    dz_ix: np.ndarray = None
    dz_iy: np.ndarray = None
    dz_t: np.ndarray = None
    dz_r: np.ndarray = None
