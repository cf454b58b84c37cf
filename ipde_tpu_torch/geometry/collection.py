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
from ipde_tpu_torch.functions import EmbeddedFunction
from ipde_tpu_torch.geometry.curve import BoundaryCurve
from ipde_tpu_torch.geometry.embedded_boundary import (EmbeddedBoundary,
                                                       load_embedded_boundary)
from ipde_tpu_torch.geometry.grid import Grid
from ipde_tpu_torch.ops.fd import fd_x_4, fd_xx_4, fd_y_4, fd_yy_4
from ipde_tpu_torch.ops.fourier import FourierPlan1D, FourierPlan2D
from ipde_tpu_torch.ops.interp import PolyInterpolator2D, make_interpolator
from ipde_tpu_torch.utils.planify import capacity
from ipde_tpu_torch.utils.profiling import spanned


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


def _cap(n: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` >= max(n, 1)."""
    return int(-(-max(n, 1) // quantum) * quantum)


def _pad_repeat(a: np.ndarray, pad: int) -> np.ndarray:
    """Pad with repeats of the first element (or 0 when empty)."""
    fill = a[0] if a.size else 0.0
    return np.concatenate([a, np.full(pad, fill, a.dtype)])


def pad_index_set(idx: np.ndarray, coords, quantum: int, sentinel: int):
    """Capacity padding of one index set and its coordinate arrays to the
    next multiple of ``quantum`` (ipde_tpu's layout): the padded indices
    are ``sentinel``, out of range of the array they scatter into, and the
    padded coordinates repeat the first real one."""
    pad = _cap(idx.size, quantum) - idx.size
    return (np.concatenate([idx, np.full(pad, sentinel, idx.dtype)]),
            [_pad_repeat(np.asarray(c), pad) for c in coords])


def set_flat(flat: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``flat`` (..., n) with flat[..., idx] = vals, where the
    slots whose index is n are dropped: ``pad_quantum`` gives padded slots
    that out-of-range index (ipde_tpu lets XLA's scatter drop them; torch's
    indexing raises on them).  The scatter goes into a buffer one element
    longer, whose last element is cut off."""
    buf = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], dim=-1)
    buf[..., idx] = vals
    return buf[..., :-1]


def add_flat(flat: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """flat (n,) with vals added at idx, slots whose index is n dropped (as
    set_flat)."""
    buf = torch.cat([flat, flat.new_zeros(1)])
    return buf.index_add(0, idx, vals)[:-1]


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
    @spanned("geometry.register")
    def register_grid(self, grid: Grid, danger_zone_distance: float = 0.0,
                      verbose: bool = False,
                      pad_quantum: Optional[int] = None):
        """Register the background grid: masks, index sets, interpolation
        plans.

        pad_quantum: when set, every VARIABLE-SIZE point set this
        registration produces (pna = physical-not-in-annulus points, and
        each boundary's in-annulus grid point set) is capacity-padded to
        the next multiple of pad_quantum, with the arrays and shapes of
        ipde_tpu: padded slots carry the out-of-range flat index Nx*Ny and
        a repeat of the first real coordinate.  Every scatter over these
        index sets drops the padded slots (``set_flat``, ``add_flat``);
        padded targets repeat a real point, which is harmless in a sum.
        The pna set's device copies (``pna_*_dev``) are padded further, to
        a capacity that a turned boundary keeps (``_pna_bound``), and the
        FFT evaluators of solvers on this collection take capacities of
        their own (``ops/grid_eval.py``).  Successive registrations of a
        moving boundary then give plan arrays of the same shapes (the
        stepper requires it, as ipde_tpu's does)."""
        self.grid = grid
        self.pad_quantum = pad_quantum
        regs = [e.register_grid(grid, danger_zone_distance, verbose)
                for e in self.ebdys]
        self.regs = regs
        self._register_masks(grid, regs, pad_quantum)
        self._register_plans(grid, regs, pad_quantum)
        self.bumpy = None

    @spanned("geometry.masks")
    def _register_masks(self, grid, regs, pad_quantum):
        """Masks, point sets and their device copies, the box's Fourier
        operators."""
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
        more = 0
        if pad_quantum:
            self.pna_flat, (self.pna_x, self.pna_y) = pad_index_set(
                self.pna_flat, (self.pna_x, self.pna_y), pad_quantum,
                grid.Nx * grid.Ny)
            # the device copies take a capacity that a turned boundary
            # keeps; the host arrays keep ipde_tpu's layout
            more = capacity(self.pna_flat.size,
                            _cap(self._pna_bound(), pad_quantum)) \
                - self.pna_flat.size
        self.pna_flat_dev = self._dev(np.concatenate(
            [self.pna_flat, np.full(more, grid.Nx * grid.Ny)]), torch.int64)
        self.pna_x_dev = self._dev(_pad_repeat(self.pna_x, more))
        self.pna_y_dev = self._dev(_pad_repeat(self.pna_y, more))

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

    def _pna_bound(self) -> int:
        """A bound on the pna points that a turned boundary keeps: they lie
        inside each interior boundary's interface curve, so the hx x hy
        cells about them lie inside that curve grown by half a cell's
        diagonal rho, of area at most A + 2 rho L + pi rho^2 (A and L the
        curve's area and length, spectrally exact); Nx Ny without an
        interior boundary."""
        g = self.grid
        rho = 0.5 * np.hypot(g.xh, g.yh)
        n = g.Nx * g.Ny
        for e in self.ebdys:
            if e.interior:
                c = e.interface
                area = 0.5 * c.dt * abs(float(np.sum(c.x * c.yp
                                                     - c.y * c.xp)))
                grown = area + 2 * rho * float(c.weights.sum()) \
                    + np.pi * rho ** 2
                n = min(n, int(grown / (g.xh * g.yh)))
        return n

    @spanned("geometry.plans")
    def _register_plans(self, grid, regs, pad_quantum):
        """The interface and radial-to-grid interpolation plans."""
        transf = self.transf
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
            ia_r, ia_t = reg.ia_r, reg.ia_t
            ia_flat = reg.ia_ix * grid.Ny + reg.ia_iy
            if pad_quantum:
                ia_flat, (ia_r, ia_t) = pad_index_set(
                    ia_flat, (ia_r, ia_t), pad_quantum, grid.Nx * grid.Ny)
            theta = e.nufft_theta(ia_r)
            plan = make_interpolator(2 * e.M, e.bdy.N, theta, ia_t,
                                     x_offset=np.pi / (2 * e.M),
                                     device=self.device)
            self.radial_to_grid_plans.append(plan)
            self.ia_flat_list.append(self._dev(ia_flat, torch.int64))

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

    def interpolate_grid_to_interface_modes(self, modes):
        """Interpolate (stacked) fft2 mode arrays to all interface points."""
        return self.interface_interp.from_modes(modes)

    def interpolate_grid_to_interface(self, f):
        """Interpolate (stacked) real grid arrays to all interface points."""
        return self.interface_interp(f)

    def interface_values_and_grads(self, modes):
        """Values and physical-coordinate gradients of the (B, nx, ny) mode
        stack at all interface points, from the interface plan's
        ``from_modes_grad``: exact trigonometric differentiation
        (``ExactInterp2D``) or the window derivatives of one fine transform
        (``PeriodicInterpolator2D``).  Returns (vals, ddx, ddy), each
        (B, T)."""
        vals, dtx, dty = self.interface_interp.from_modes_grad(modes)
        sx = 2.0 * np.pi / self.grid.x_period
        sy = 2.0 * np.pi / self.grid.y_period
        return vals, dtx * sx, dty * sy

    def interpolate_radial_to_grid(self, radials, grid_vals):
        """Write radial-grid functions onto their in-annulus grid points.
        radials: list of (M, N_b) tensors; grid_vals: (Nx, Ny); returns a new
        grid tensor."""
        return self.interpolate_radial_to_grid_many([radials], [grid_vals])[0]

    def interpolate_radial_to_grid_many(self, radials_list, grid_vals_list):
        """interpolate_radial_to_grid for F fields at once: each
        per-boundary plan evaluates all F fields in one call.
        radials_list: per-field lists of per-boundary (M, N_b) radials;
        grid_vals_list: F (Nx, Ny) grids; returns F new grid tensors."""
        flats = torch.stack([g.reshape(-1) for g in grid_vals_list])
        for b, (plan, idx) in enumerate(zip(self.radial_to_grid_plans,
                                            self.ia_flat_list)):
            refls = torch.stack([torch.cat([fr[b], fr[b].flip(0)], dim=0)
                                 for fr in radials_list])
            flats = set_flat(flats, idx, plan(refls))
        return [flat.reshape(g.shape)
                for flat, g in zip(flats, grid_vals_list)]

    def interpolate_radial_to_boundary(self, radials):
        """Boundary values (N_b,) of each boundary's radial function."""
        return [self._dev(e.interp_f_to_bdy) @ fr
                for e, fr in zip(self.ebdys, radials)]

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
    # calculus on EmbeddedFunctions
    # ------------------------------------------------------------------
    def gradient(self, ef: EmbeddedFunction,
                 derivative_type: str = "spectral"):
        """Gradient: spectral (FFT) or 4th-order FD on the grid; exact
        curvilinear derivatives on the radial grids (reference:
        ipde/ebdy_collection.py:711-753)."""
        fc = ef.grid * self.grid_step_dev
        if derivative_type == "spectral":
            fx = self.fft_plan.deriv_x(fc, self.kx_dev)
            fy = self.fft_plan.deriv_y(fc, self.ky_dev)
        elif derivative_type == "fourth":
            fx = fd_x_4(fc, self.grid.xh)
            fy = fd_y_4(fc, self.grid.yh)
        else:
            raise ValueError(derivative_type)
        fxrs, fyrs = [], []
        for e, fr in zip(self.ebdys, ef.radials):
            fxr, fyr = self._radial_gradient(e, fr)
            fxrs.append(fxr)
            fyrs.append(fyr)
        fx, fy = self.interpolate_radial_to_grid_many([fxrs, fyrs], [fx, fy])
        return (EmbeddedFunction(fx * self.phys_dev, fxrs),
                EmbeddedFunction(fy * self.phys_dev, fyrs))

    def laplacian(self, ef: EmbeddedFunction,
                  derivative_type: str = "spectral") -> EmbeddedFunction:
        """Laplacian; grid part spectral or 4th-order FD, radial part via the
        curvilinear metric lap u = u_rr + (psi_r/psi) u_r +
        (1/psi) d_t(u_t / psi) (reference: ipde/ebdy_collection.py:754-792,
        embedded_boundary.py:478-517)."""
        fc = ef.grid * self.grid_step_dev
        if derivative_type == "spectral":
            fl = self.fft_plan.solve_symbol(fc, self._dev(self.lap))
        elif derivative_type == "fourth":
            fl = fd_xx_4(fc, self.grid.xh) + fd_yy_4(fc, self.grid.yh)
        else:
            raise ValueError(derivative_type)
        flrs = [self._radial_laplacian(e, fr)
                for e, fr in zip(self.ebdys, ef.radials)]
        fl = self.interpolate_radial_to_grid(flrs, fl) * self.phys_dev
        return EmbeddedFunction(fl, flrs)

    def interpolate_grid_to_radial(self, f, order: int = 3):
        """Interpolate a (smooth-everywhere!) grid function onto each radial
        grid by periodic polynomial interpolation (reference:
        ipde/ebdy_collection.py:630-648; useful for initialization only --
        the grid function must be smooth across the boundaries)."""
        g = self.grid
        f = self._dev(f) if not isinstance(f, torch.Tensor) else f
        out = []
        for e in self.ebdys:
            interp = PolyInterpolator2D(
                g.x_bounds[0], g.y_bounds[0], g.xh, g.yh, g.Nx, g.Ny,
                e.radial_x.ravel(), e.radial_y.ravel(), order=order,
                device=self.device)
            out.append(interp(f).reshape(e.radial_shape))
        return out

    def _radial_gradient(self, e: EmbeddedBoundary, fr):
        plan = FourierPlan1D(e.bdy.N, device=self.device)
        ft = plan.tderiv(fr) * self._dev(e.inverse_radial_speed)
        frr = self._dev(e.D00) @ fr
        b = e.bdy
        return (frr * self._dev(b.normal_x) + ft * self._dev(b.tangent_x),
                frr * self._dev(b.normal_y) + ft * self._dev(b.tangent_y))

    def _radial_laplacian(self, e: EmbeddedBoundary, fr):
        plan = FourierPlan1D(e.bdy.N, device=self.device)
        D00 = self._dev(e.D00)
        ipsi = self._dev(e.inverse_radial_speed)
        psi_r = self._dev(e.bdy.speed * e.bdy.curvature)    # (n,)
        u_r = D00 @ fr
        u_rr = D00 @ u_r
        u_t = plan.tderiv(fr)
        return u_rr + psi_r * ipsi * u_r + ipsi * plan.tderiv(u_t * ipsi)

    def volume_integral(self, ef: EmbeddedFunction) -> float:
        """Integral of ef over the physical domain: the rolled-off grid part
        on the box plus each radial part with its quadrature."""
        val = float((ef.grid * self.grid_step_dev).sum()
                    * self.grid.xh * self.grid.yh)
        for e, fr in zip(self.ebdys, ef.radials):
            val += e.radial_integral(fr.cpu().numpy())
        return val

    # ------------------------------------------------------------------
    def save(self) -> dict:
        return {"ebdys": [e.save() for e in self.ebdys]}


def load_collection(d: dict, device=None) -> EmbeddedBoundaryCollection:
    """Collection from the dict of either package's ``save``; ``device`` as
    for ``EmbeddedBoundaryCollection`` (None: the CUDA card)."""
    return EmbeddedBoundaryCollection(
        [load_embedded_boundary(e) for e in d["ebdys"]], device=device)
