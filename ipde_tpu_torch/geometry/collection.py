"""EmbeddedBoundaryCollection: the multi-boundary embedded domain.

Redesign of the reference's EmbeddedBoundaryCollection (reference:
ipde/ebdy_collection.py:230-829).  Host numpy builds all masks, index sets
and interpolation plans once per (geometry, grid); the solve-time state is a
set of tensors and plans on the collection's device, which every solver and
BIE built from the collection uses.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ipde_tpu_torch.config import require_cuda
from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.geometry.embedded_boundary import (EmbeddedBoundary,
                                                       load_embedded_boundary)
from ipde_tpu_torch.geometry.grid import Grid
from ipde_tpu_torch.ops.fourier import FourierPlan2D
from ipde_tpu_torch.ops.interp import make_interpolator


def grid_inside_mask(bdy: BoundaryCurve, grid: Grid) -> np.ndarray:
    """Even-odd inside mask on the full uniform grid via scanline crossings
    of a refined polyline (O(Nx*Ny + n_segments * rows-per-segment))."""
    ups = bdy.resampled(max(8 * bdy.N, 1024))
    xs, ys = ups.x, ups.y
    xe, ye = np.roll(xs, -1), np.roll(ys, -1)
    Nx, Ny = grid.Nx, grid.Ny
    diff = np.zeros((Nx + 1, Ny), dtype=np.int64)
    # rows (y values) each segment crosses
    ylo = np.minimum(ys, ye)
    yhi = np.maximum(ys, ye)
    j0 = np.searchsorted(grid.yv, ylo, side="left")
    j1 = np.searchsorted(grid.yv, yhi, side="left")
    for s in range(xs.size):
        a, b = j0[s], j1[s]
        if a == b:
            continue
        jj = np.arange(a, b)
        yc = grid.yv[jj]
        xc = xs[s] + (yc - ys[s]) * (xe[s] - xs[s]) / (ye[s] - ys[s])
        ii = np.searchsorted(grid.xv, xc, side="right")
        np.add.at(diff, (ii, jj), 1)
    # point (i, j) is inside iff the number of crossings at x > xv[i] is odd
    counts = np.cumsum(diff[::-1], axis=0)[::-1][1:]
    return (counts % 2) == 1


class EmbeddedBoundaryCollection:
    def __init__(self, ebdys: Sequence[EmbeddedBoundary], device=None):
        """device: where the solve-time tensors of the collection, and of
        every solver and BIE built from it, live.  None means the first
        CUDA card (``config.require_cuda``), and raises without one: the
        CPU is used only where the caller names it."""
        self.ebdys = list(ebdys)
        self.N = len(self.ebdys)
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.grid = None
        self.bump_location = None
        self.bumpy = None

    def __iter__(self):
        return iter(self.ebdys)

    def __getitem__(self, i):
        return self.ebdys[i]

    def __len__(self):
        return self.N

    def _dev(self, a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def generate_grid(self, h: Optional[float] = None,
                      danger_zone_distance: float = 0.0,
                      pad_quantum: Optional[int] = None) -> Grid:
        """Auto-generate the background box: the first boundary must be the
        interior one; pad by one radial width, plus bump room at the top
        right (reference: ipde/ebdy_collection.py:280-341)."""
        ie = self.ebdys[0]
        if not ie.interior:
            raise ValueError("generate_grid requires the first boundary to "
                             "be interior")
        if h is None:
            h = ie.h
        cheat = ie.radial_width
        xmin = ie.bdy.x.min() - cheat
        ymin = ie.bdy.y.min() - cheat
        xmax = ie.bdy.x.max() + 2 * cheat
        ymax = ie.bdy.y.max() + 2 * cheat
        self.bump_location = (ie.bdy.x.max() + cheat, ie.bdy.y.max() + cheat)
        # multiples of 32, as ipde_tpu sizes the box: both packages then
        # build the same grid for one problem
        Nx = int(32 * np.ceil((xmax - xmin) / h / 32))
        Ny = int(32 * np.ceil((ymax - ymin) / h / 32))
        grid = Grid([xmin, xmin + Nx * h], Nx, [ymin, ymin + Ny * h], Ny)
        self.register_grid(grid, danger_zone_distance=danger_zone_distance,
                           pad_quantum=pad_quantum)
        return grid

    # ------------------------------------------------------------------
    def register_grid(self, grid: Grid, danger_zone_distance: float = 0.0,
                      verbose: bool = False,
                      pad_quantum: Optional[int] = None):
        """Register the background grid: masks, index sets, interpolation
        plans.  pad_quantum (fixed-shape registrations for moving
        boundaries) is not ported."""
        if pad_quantum:
            raise NotImplementedError(
                "pad_quantum is not ported to ipde_tpu_torch "
                "(ROADMAP.md Queue 1)")
        self.grid = grid
        self.pad_quantum = None
        regs = [e.register_grid(grid, danger_zone_distance, verbose)
                for e in self.ebdys]
        self.regs = regs

        # physical mask: intersection over boundaries; near-curve points are
        # classified exactly by the sign of their radial coordinate
        phys = np.ones(grid.shape, dtype=bool)
        for e, reg in zip(self.ebdys, regs):
            inside = grid_inside_mask(e.bdy, grid)
            inside[reg.near_ix, reg.near_iy] = reg.near_r < 0
            phys &= inside if e.interior else ~inside
        self.phys = phys
        self.ext = ~phys
        self.phys_n = int(phys.sum())

        # in-annulus mask and phys-not-annulus
        ia = np.zeros(grid.shape, dtype=bool)
        overlap = 0
        for reg in regs:
            overlap += int(ia[reg.ia_ix, reg.ia_iy].sum())
            ia[reg.ia_ix, reg.ia_iy] = True
        if overlap:
            import warnings
            warnings.warn(
                f"{overlap} grid points lie in MORE THAN ONE boundary's "
                "annulus: the radial strips overlap and the solve will be "
                "silently wrong.  Reduce M (strip width = M*h) or separate "
                "the boundaries.")
        self.in_annulus = ia
        self.phys_not_in_annulus = phys & ~ia
        self.pna_flat = np.flatnonzero(self.phys_not_in_annulus)
        self.pna_x = grid.xg[self.phys_not_in_annulus]
        self.pna_y = grid.yg[self.phys_not_in_annulus]
        self.pna_flat_dev = self._dev(self.pna_flat, torch.int64)
        self.pna_x_dev = self._dev(self.pna_x)
        self.pna_y_dev = self._dev(self.pna_y)

        # smoothed step: 1 deep inside, rolls to 0 through each annulus
        gs = phys.astype(np.float64)
        for reg in regs:
            gs[reg.ia_ix, reg.ia_iy] *= reg.grid_to_radial_step
        self.grid_step = gs
        self.grid_step_dev = self._dev(gs)
        self.phys_dev = self._dev(phys, torch.bool)

        # Fourier operators for the box
        self.kx = np.fft.fftfreq(grid.Nx, grid.xh / (2 * np.pi))[:, None]
        self.ky = np.fft.fftfreq(grid.Ny, grid.yh / (2 * np.pi))[None, :]
        self.lap = -self.kx**2 - self.ky**2
        self.kx_dev = self._dev(self.kx)
        self.ky_dev = self._dev(self.ky)
        self.fft_plan = FourierPlan2D(grid.Nx, grid.Ny)

        # transformed coordinates (box -> [0, 2pi)^2) for spectral interp
        def transf(x, y):
            tx = (np.asarray(x) - grid.x_bounds[0]) / grid.x_period * 2 * np.pi
            ty = (np.asarray(y) - grid.y_bounds[0]) / grid.y_period * 2 * np.pi
            return tx, ty
        self.transf = transf

        # interface interpolation plan (all interfaces concatenated)
        ifx = np.concatenate([e.interface.x for e in self.ebdys])
        ify = np.concatenate([e.interface.y for e in self.ebdys])
        self.all_interface_x = ifx
        self.all_interface_y = ify
        self.all_interface_x_dev = self._dev(ifx)
        self.all_interface_y_dev = self._dev(ify)
        tx, ty = transf(ifx, ify)
        self.interface_interp = make_interpolator(grid.Nx, grid.Ny, tx, ty,
                                                  device=self.device)
        self.bdy_Ns = [e.bdy.N for e in self.ebdys]

        # radial -> grid interpolation plans (Chebyshev reflection)
        self.radial_to_grid_plans = []
        self.ia_flat_list = []
        for e, reg in zip(self.ebdys, regs):
            theta = e.nufft_theta(reg.ia_r)
            plan = make_interpolator(2 * e.M, e.bdy.N, theta, reg.ia_t,
                                     x_offset=np.pi / (2 * e.M),
                                     device=self.device)
            self.radial_to_grid_plans.append(plan)
            self.ia_flat_list.append(
                self._dev(reg.ia_ix * grid.Ny + reg.ia_iy, torch.int64))
        self.bumpy = None

    def phys_extremes(self) -> np.ndarray:
        """(K, 2) superset of the physical region's convex-hull vertices
        (per-column extremal phys points; every hull vertex of a gridded
        point set is a column extreme)."""
        cached = getattr(self, "_phys_extremes", None)
        if cached is not None:
            return cached
        phys = self.phys
        g = self.grid
        cols = np.flatnonzero(phys.any(axis=1))
        iy_min = np.argmax(phys[cols], axis=1)
        iy_max = phys.shape[1] - 1 - np.argmax(phys[cols, ::-1], axis=1)
        pts = np.concatenate([
            np.stack([g.xv[cols], g.yv[iy_min]], axis=1),
            np.stack([g.xv[cols], g.yv[iy_max]], axis=1)])
        from scipy.spatial import ConvexHull
        pts = pts[ConvexHull(pts).vertices]
        self._phys_extremes = pts
        return pts

    def phys_bounds(self):
        """((x0, x1), (y0, y1)): the bounding box of the physical grid
        points, the targets whose FFT grid evaluator values are used."""
        px = self.grid.xg[self.phys]
        py = self.grid.yg[self.phys]
        return ((float(px.min()), float(px.max())),
                (float(py.min()), float(py.max())))

    # ------------------------------------------------------------------
    # interpolation operations (device)
    # ------------------------------------------------------------------
    def v2l(self, v):
        """Split a concatenated boundary-length vector into per-boundary
        views."""
        return list(torch.split(v, self.bdy_Ns))

    def interface_values_and_grads(self, modes):
        """Values and physical-coordinate gradients of the (B, nx, ny) mode
        stack at all interface points, from one exact evaluation with the
        derivatives folded into the phases.  Returns (vals, ddx, ddy), each
        (B, T)."""
        vals, dtx, dty = self.interface_interp.from_modes_grad(modes)
        sx = 2.0 * np.pi / self.grid.x_period
        sy = 2.0 * np.pi / self.grid.y_period
        return vals, dtx * sx, dty * sy

    def interpolate_radial_to_grid(self, radials, grid_vals):
        """Write radial-grid functions onto their in-annulus grid points.
        radials: list of (M, N_b) tensors; grid_vals: (Nx, Ny); returns a new
        grid tensor."""
        flat = grid_vals.reshape(-1).clone()
        for plan, idx, fr in zip(self.radial_to_grid_plans,
                                 self.ia_flat_list, radials):
            refl = torch.cat([fr, fr.flip(0)], dim=0)
            flat[idx] = plan(refl)
        return flat.reshape(grid_vals.shape)

    def interpolate_radial_to_grid_many(self, radials_list, grid_vals_list):
        """interpolate_radial_to_grid for F fields at once: each
        per-boundary plan evaluates all F fields in one call.
        radials_list: per-field lists of per-boundary (M, N_b) radials;
        grid_vals_list: F (Nx, Ny) grids; returns F new grid tensors."""
        flats = [g.reshape(-1).clone() for g in grid_vals_list]
        for b, (plan, idx) in enumerate(zip(self.radial_to_grid_plans,
                                            self.ia_flat_list)):
            refls = torch.stack([torch.cat([fr[b], fr[b].flip(0)], dim=0)
                                 for fr in radials_list])
            for flat, vals in zip(flats, plan(refls)):
                flat[idx] = vals
        return [flat.reshape(g.shape)
                for flat, g in zip(flats, grid_vals_list)]

    # ------------------------------------------------------------------
    # bump de-meaning (Poisson solvability on the periodic box)
    # ------------------------------------------------------------------
    def ready_bump(self, bump_loc=None, bump_width=None):
        """Normalized compactly-supported bump used to remove the mean of
        the extended forcing (reference: ipde/ebdy_collection.py:796-810)."""
        if bump_width is None:
            bump_width = self.ebdys[0].radial_width
        if bump_loc is None:
            bump_loc = self.bump_location
        if bump_loc is None:
            raise ValueError("no bump location available")
        mol = self.ebdys[0].mollifier
        rr = np.hypot(self.grid.xg - bump_loc[0], self.grid.yg - bump_loc[1])
        bumpy = mol.bump(rr / bump_width)
        integral = bumpy.sum() * self.grid.xh * self.grid.yh
        self.bumpy = self._dev(bumpy / integral)

    def demean_function(self, f):
        f_int = f.sum() * (self.grid.xh * self.grid.yh)
        return f - f_int * self.bumpy

    # ------------------------------------------------------------------
    def save(self) -> dict:
        return {"ebdys": [e.save() for e in self.ebdys]}


def load_collection(d: dict, device=None) -> EmbeddedBoundaryCollection:
    """Collection from the dict of either package's ``save``; ``device`` as
    for ``EmbeddedBoundaryCollection`` (None: the CUDA card)."""
    return EmbeddedBoundaryCollection(
        [load_embedded_boundary(e) for e in d["ebdys"]], device=device)
