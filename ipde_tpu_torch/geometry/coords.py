"""Local boundary-fitted coordinates and point classification (host, numpy).

For a closed curve c(t) with outward normal n(t), every point p close to the
curve has unique coordinates (t, r) with p = c(t) + r n(t).  This module
finds them with a vectorized Newton iteration seeded from the nearest curve
node (cKDTree), plus inside/outside classification.

Replaces the reference's external near_finder package surface:
gridpoints_near_curve / compute_local_coordinates / points_inside_curve
(SURVEY.md section 2.2).  These run at geometry setup on the host; the
resulting index sets and coordinates are static data for the solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

from ipde_tpu_torch.geometry.curve import BoundaryCurve


class CoordResult(NamedTuple):
    t: np.ndarray
    r: np.ndarray
    converged: np.ndarray


def compute_local_coordinates(bdy: BoundaryCurve, px: np.ndarray,
                              py: np.ndarray, guess_t: np.ndarray = None,
                              newton_tol: float = 1e-14,
                              max_iter: int = 50) -> CoordResult:
    """Solve p = c(t) + r n(t) for (t, r) by Newton on
    g(t) = (p - c(t)) . c'(t) = 0, then r = (p - c(t)) . n(t).

    guess_t: initial parameter guesses; nearest-node via KDTree if omitted.
    """
    px = np.asarray(px, np.float64).ravel()
    py = np.asarray(py, np.float64).ravel()
    if guess_t is None:
        tree = cKDTree(np.column_stack([bdy.x, bdy.y]))
        _, idx = tree.query(np.column_stack([px, py]))
        t = bdy.t[idx].copy()
    else:
        t = np.asarray(guess_t, np.float64).copy()

    # Fourier coefficients for fast evaluation: ONE phase matrix per Newton
    # iteration evaluates c, c', c'' together (the exp is the dominant host
    # cost; it runs on the ACTIVE subset only, which shrinks fast)
    N = bdy.N
    ik = 1j * bdy.k
    C6 = np.stack([bdy.xh, bdy.yh, ik * bdy.xh, ik * bdy.yh,
                   ik * ik * bdy.xh, ik * ik * bdy.yh], axis=1) / N
    k = bdy.k

    def ev6(t_):
        ph = np.exp(1j * t_[:, None] * k[None, :])
        return (ph @ C6).real        # (na, 6): cx cy cxp cyp cxpp cypp

    scale = float(np.mean(bdy.speed) ** 2)
    act = np.arange(t.size)          # indices still iterating
    for _ in range(max_iter):
        E = ev6(t[act])
        dx, dy = px[act] - E[:, 0], py[act] - E[:, 1]
        g = dx * E[:, 2] + dy * E[:, 3]
        gp = -(E[:, 2] ** 2 + E[:, 3] ** 2) + dx * E[:, 4] + dy * E[:, 5]
        # guard: keep Newton well-defined; damp where |gp| is tiny
        gp = np.where(np.abs(gp) < 1e-12 * scale,
                      np.sign(gp + 1e-300) * 1e-12 * scale, gp)
        # limit step size for robustness
        dt_step = np.clip(g / gp, -0.5, 0.5)
        t[act] = t[act] - dt_step
        act = act[np.abs(g) > newton_tol * scale]
        if act.size == 0:
            break
    t = np.mod(t, 2 * np.pi)
    E = ev6(t)
    cx, cy, cxp, cyp = E[:, 0], E[:, 1], E[:, 2], E[:, 3]
    sp = np.hypot(cxp, cyp)
    nx, ny = cyp / sp, -cxp / sp
    r = (px - cx) * nx + (py - cy) * ny
    # converged check: residual tangential component small
    g = (px - cx) * cxp + (py - cy) * cyp
    conv = np.abs(g) <= 100 * newton_tol * scale
    return CoordResult(t, r, conv)


def points_near_curve(bdy: BoundaryCurve, px: np.ndarray, py: np.ndarray,
                      dist: float):
    """Boolean mask of points within `dist` of the curve (conservative), plus
    nearest-node parameter guesses for the subsequent Newton solve."""
    px = np.asarray(px, np.float64).ravel()
    py = np.asarray(py, np.float64).ravel()
    # upsample the curve so polyline distance is accurate to << h
    ups = bdy.resampled(max(4 * bdy.N, 512))
    tree = cKDTree(np.column_stack([ups.x, ups.y]))
    d, idx = tree.query(np.column_stack([px, py]),
                        distance_upper_bound=dist + ups.max_h())
    near = np.isfinite(d)
    guess_t = np.zeros(px.size)
    guess_t[near] = ups.t[idx[near] % ups.N]
    return near, guess_t


def points_inside_curve(bdy: BoundaryCurve, px: np.ndarray, py: np.ndarray,
                        near: np.ndarray = None, r: np.ndarray = None):
    """Even-odd (crossing number) test, vectorized over a fine polyline.

    For points with known signed coordinate r (from the Newton solve), the
    sign of r decides; callers pass those in to avoid ambiguity right at the
    curve.  Interior <-> r < 0 (outward normal convention).
    """
    px = np.asarray(px, np.float64).ravel()
    py = np.asarray(py, np.float64).ravel()
    ups = bdy.resampled(max(4 * bdy.N, 512))
    xs, ys = ups.x, ups.y
    try:
        # C-implemented even-odd test (~10x the numpy sweep); same
        # fine-polyline geometry, identical results on all test points
        from matplotlib.path import Path
        inside = Path(np.column_stack([xs, ys])).contains_points(
            np.column_stack([px, py]))
        if near is not None and r is not None:
            inside[near] = r[near] < 0.0
        return inside
    except ImportError:
        pass
    xe, ye = np.roll(xs, -1), np.roll(ys, -1)
    inside = np.zeros(px.size, dtype=bool)
    # crossing-number algorithm, chunked to bound memory
    chunk = max(1, int(2e7 // max(xs.size, 1)))
    for i0 in range(0, px.size, chunk):
        sl = slice(i0, min(i0 + chunk, px.size))
        X = px[sl][:, None]
        Y = py[sl][:, None]
        cond = (ys[None, :] <= Y) != (ye[None, :] <= Y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = xs[None, :] + (Y - ys[None, :]) / (ye[None, :] - ys[None, :]) * (xe[None, :] - xs[None, :])
        crossings = np.sum(cond & (xint > X), axis=1)
        inside[sl] = (crossings % 2) == 1
    if near is not None and r is not None:
        inside[near] = r[near] < 0.0
    return inside


def grid_points_near_curve(bdy: BoundaryCurve, xv: np.ndarray, yv: np.ndarray,
                           dist: float, newton_tol: float = 1e-14):
    """Find grid points within `dist` of the curve and their coordinates.

    Returns (ix, iy, t, r): integer indices into (xv, yv) and local coords.
    Reference analogue: near_finder.gridpoints_near_curve
    (used at ipde/embedded_boundary.py:202-206).

    Runs the native C++ kernel (ipde_tpu_torch/native), which prints once
    that it ran; a failed build raises instead of falling back.
    """
    from ipde_tpu_torch.native import grid_near_coords_native
    return grid_near_coords_native(bdy, np.asarray(xv), np.asarray(yv),
                                   dist, newton_tol)
