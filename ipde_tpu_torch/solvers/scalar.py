"""Inhomogeneous scalar solvers (Poisson, modified Helmholtz) on an
embedded-boundary domain.

The solve path (reference: ipde/solvers/multi_boundary/scalar.py:72-117,
internals/scalar.py:68-116, multi_boundary/poisson.py,
modified_helmholtz.py):

  1. periodic box solve of the rolled-off forcing (torch.fft + symbol),
  2. (u, ux, uy) at all interfaces: exact trigonometric evaluation of the
     mode array (``solver_type="spectral"``), or 4th-order finite
     differences on the grid and 3rd-order polynomial interpolation
     (``solver_type="fourth"``),
  3. per boundary: annular strip solve with zero BCs (GMRES; one
     lockstep GMRES over all boundaries when they share one (M, n)),
     interface mismatch -> SLP/DLP densities -> QFS effective densities
     sigma_g (grid side) and sigma_r (radial side),
  4. one global layer-potential evaluation of all sigma_g onto the
     grid-not-in-annulus points (see Grid backend below) and all
     interfaces (CUDA kernel),
  5. per boundary 'correct': subtract own contribution, u2s re-match,
     evaluate total sigma_r onto the radial grid (CUDA kernel),
  6. radial->grid merge, mask to the physical region.

Derivation of the interface densities: continuity and C^1 matching of
(uc + L) and (ur + L) across the interface give
    dlp = uc|_ifc     slp = d(ur)/dn - d(uc)/dn
with both negated for exterior boundaries.

Grid backend (step 4), as in ipde_tpu: ``grid_backend="fft"``, the
default, evaluates the merged sigma_g on the whole grid with the free-space
FFT evaluator (``ops/grid_eval.py``) and at the interfaces with the CUDA
kernel; ``"dense"`` sums it directly at every physical-not-in-annulus grid
point and the interfaces in one kernel launch.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                add_flat)
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels, singular as sq
from ipde_tpu_torch.ops.fd import fd_x_4, fd_y_4
from ipde_tpu_torch.ops.grid_eval import FreespaceGridEvaluator
from ipde_tpu_torch.ops.interp import PolyInterpolator2D
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.qfs.qfs import QFSEvaluator, laplace_qfs, mh_qfs
from ipde_tpu_torch.solvers.annular_scalar import (
    AnnularModifiedHelmholtzSolver, AnnularPoissonSolver,
    batched_annular_solve)


def _annular_donor(prev_helper, solver, ebdy):
    """The previous helper's annular solver, if its geometry still fits
    (``AnnularGeometry.fits``) and it solves the same PDE (the same
    Helmholtz k).  The per-mode preconditioner is built from the circle
    approximation; under moving-boundary regeneration (fixed h, M) only the
    radius drifts, and the preconditioner stays effective for modest drift:
    GMRES corrects the rest.  The true metric is rebuilt each step
    regardless (ops are cached per AnnularMetric)."""
    if prev_helper is None:
        return None
    a = prev_helper.annular_solver
    if a.geom.fits(ebdy) and solver._annular_solver_signature() == (
            type(a).__name__, a.helmholtz_k):
        return a
    return None


class _ScalarHelper:
    """Per-boundary machinery: annular solver + QFS maps + estimator rows."""

    def __init__(self, solver, ebdy: EmbeddedBoundary, shared_annular=None):
        self.ebdy = ebdy
        self.interior = ebdy.interior
        dev = solver.device
        geom = AnnularGeometry(ebdy.bdy.N, ebdy.M, ebdy.lb, ebdy.ub,
                               ebdy.approximate_radius)
        self.geom = geom
        self.annular_solver = (shared_annular if shared_annular is not None
                               else solver._make_annular_solver(geom))
        self.metric = AnnularMetric(ebdy.bdy.speed, ebdy.bdy.curvature, geom)
        ifc = ebdy.interface
        alpha = solver._qfs_alpha(ebdy)
        self.grid_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=self.interior, alpha=alpha)
        self.radial_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=not self.interior, alpha=alpha)
        # qfs_g's u2s map is never consumed (only qfs_r.u2s in correct)
        self.qfs_g = solver._make_qfs(ifc, self.grid_source, self.interior,
                                      build_u2s=False)
        self.qfs_r = solver._make_qfs(ifc, self.radial_source,
                                      not self.interior)
        # own grid-source -> own interface dense matrix (for 'correct'),
        # formed on the host and uploaded
        self.own_src_to_ifc = solver._naive_form_dev(self.grid_source,
                                                     ifc.x, ifc.y)
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                        device=dev)
        # estimator rows
        self.f_to_bdy = f64(ebdy.interp_f_to_bdy)
        self.dn_to_bdy = f64(ebdy.interp_dn_to_bdy)
        self.dn_to_ifc = f64(ebdy.interp_dn_to_interface)
        self.ifc_normal = (f64(ifc.normal_x), f64(ifc.normal_y))
        # stratified source subsampling for the dense radial apply in
        # `correct` (rows far from the source curve need fewer sources)
        self.radial_plan = StratifiedRadialApply(
            self.radial_source, ebdy.radial_x, ebdy.radial_y,
            k_density=ebdy.bdy.N // 2, device=dev)
        self.annular_solver.make_ops(self.metric)   # warm the ops cache
        self.zero_bc = torch.zeros(ebdy.bdy.N, dtype=torch.float64,
                                   device=dev)
        self.iterations_last_call = 0

    def solve_and_densities(self, fr, bv, bx, by, tol, maxiter, restart):
        """Annular solve + QFS densities (reference: internals/scalar.py:68-94)."""
        ur, stats = self.annular_solver.solve_with_stats(
            self.metric, fr, self.zero_bc, self.zero_bc, tol=tol,
            maxiter=maxiter, restart=restart)
        self.iterations_last_call = self.annular_solver.iterations_last_call
        sigma_g, sigma_r = self.densities(ur, bv, bx, by)
        return ur, sigma_g, sigma_r, stats

    def annular_rhs(self, fr):
        """The zero-BC annular right-hand side (batched path)."""
        return self.annular_solver.build_rhs(fr, self.zero_bc, self.zero_bc)

    def densities(self, ur, bv, bx, by):
        """QFS effective densities from the annular solution + interface
        data (the non-GMRES half of solve_and_densities)."""
        urn = self.dn_to_ifc @ ur
        ucn = bx * self.ifc_normal[0] + by * self.ifc_normal[1]
        slp = urn - ucn
        dlp = bv
        if not self.interior:
            slp = -slp
            dlp = -dlp
        return self.qfs_g([slp, dlp]), self.qfs_r([slp, dlp])

    def correct(self, solver, ur, sigma_g, sigma_r, bu):
        """Fold in other boundaries' fields (reference: internals/scalar.py:95-116)."""
        # own_src_to_ifc is a naive form: quadrature weights already folded in
        w = self.own_src_to_ifc @ sigma_g
        sigma_r_tot = sigma_r + self.qfs_r.u2s(bu - w)
        rslp = self.radial_plan.apply(
            lambda sx, sy, ws, f, tx, ty: solver._apply_raw(
                sx, sy, sigma_r_tot[::f] * ws, tx, ty))
        return ur + rslp


class ScalarSolver:
    """Shared orchestration; subclasses bind the PDE (symbol, kernel, QFS).

    The collection holds one interior boundary and any number of inclusions
    (``interior=False``).  helpers: the helpers of a previous solver on
    compatible geometry (same n, M, radial bounds, about the same radius):
    their annular solvers and preconditioners are reused, the dominant
    per-step setup cost of moving-boundary runs.  grid_backend: 'fft' (the
    default) evaluates the sigma_g layer potential on the grid with the
    free-space FFT evaluator; 'dense' uses the direct kernel sum onto every
    physical-not-in-annulus grid point.  solver_type: 'spectral' (the
    interface values and gradients from the mode array) or 'fourth'
    (4th-order FD grid derivatives and 3rd-order polynomial interface
    interpolation: cheaper, about 1e-6 accurate; reference:
    ipde/solvers/multi_boundary/scalar.py:25,47,80-95).  Reference analogue
    of grid_backend: ipde/solvers/multi_boundary/poisson.py:39-64.

    GMRES tol: the annular solves check the TRUE residual and raise above
    tol; its float64 floor is about 3e-14 (Poisson), so the default is
    1e-12, not ipde_tpu's 1e-14.
    """

    def __init__(self, ebdyc: EmbeddedBoundaryCollection,
                 helpers: Optional[List] = None, grid_backend: str = "fft",
                 solver_type: str = "spectral"):
        self.ebdyc = ebdyc
        if ebdyc.grid is None:
            raise ValueError("collection has no registered grid")
        if grid_backend not in ("fft", "dense"):
            raise ValueError(grid_backend)
        if solver_type not in ("spectral", "fourth"):
            raise ValueError(solver_type)
        self.device = ebdyc.device
        self.grid_backend = grid_backend
        self.solver_type = solver_type
        if solver_type == "fourth":
            g = ebdyc.grid
            self.ifc_poly_interp = PolyInterpolator2D(
                g.x_bounds[0], g.y_bounds[0], g.xh, g.yh, g.Nx, g.Ny,
                ebdyc.all_interface_x, ebdyc.all_interface_y, order=3,
                device=self.device)
        donors = list(helpers or [])
        donors += [None] * (len(ebdyc.ebdys) - len(donors))
        self.helpers = [
            _ScalarHelper(self, e, shared_annular=_annular_donor(d, self, e))
            for e, d in zip(ebdyc, donors)]
        # merged grid sources
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                        device=self.device)
        self.grid_src_x = f64(np.concatenate(
            [h.grid_source.x for h in self.helpers]))
        self.grid_src_y = f64(np.concatenate(
            [h.grid_source.y for h in self.helpers]))
        self.grid_src_w = f64(np.concatenate(
            [h.grid_source.weights for h in self.helpers]))
        self._symbol = f64(self._grid_symbol())
        if grid_backend == "fft":
            self.grid_eval = self._make_grid_evaluator(
                np.concatenate([h.grid_source.x for h in self.helpers]),
                np.concatenate([h.grid_source.y for h in self.helpers]))
            self._pna_mask = torch.as_tensor(ebdyc.phys_not_in_annulus,
                                             device=self.device)
        else:
            # the grid targets of the merged apply in spatial order (compact
            # warps for the Yukawa kernel), with the flat indices their
            # values are scattered to in the same order; the interface
            # points follow
            order = kernels.spatial_order(
                ebdyc.pna_x_dev, ebdyc.pna_y_dev,
                cell=min(ebdyc.grid.xh, ebdyc.grid.yh))
            self._pna_flat = ebdyc.pna_flat_dev[order]
            self._dense_tx = torch.cat([ebdyc.pna_x_dev[order],
                                        ebdyc.all_interface_x_dev])
            self._dense_ty = torch.cat([ebdyc.pna_y_dev[order],
                                        ebdyc.all_interface_y_dev])
        self.iteration_counts = []

    def _make_grid_evaluator(self, gx, gy) -> FreespaceGridEvaluator:
        """The FFT evaluator of this PDE's kernel for sources (gx, gy),
        truncated for the physical points."""
        raise NotImplementedError

    # -- PDE bindings (overridden) -----------------------------------------
    def _qfs_alpha(self, ebdy):
        """QFS source-shift override in parameter spacings (None = the
        geometry default, 1.5; the high-k Yukawa kernel needs more)."""
        return None

    def _make_annular_solver(self, geom):
        raise NotImplementedError

    def _annular_solver_signature(self):
        """(class name, Helmholtz k) of the annular solver the PDE binding
        builds; the helper-reuse check (_annular_donor) compares it."""
        raise NotImplementedError

    def _make_qfs(self, curve, source, interior,
                  build_u2s: bool = True) -> QFSEvaluator:
        raise NotImplementedError

    def _make_qfs_slp_only(self, curve, source, interior) -> QFSEvaluator:
        raise NotImplementedError

    def _naive_form(self, src, tx, ty) -> np.ndarray:
        raise NotImplementedError

    def _naive_form_dev(self, src, tx, ty):
        """The host naive form, uploaded to the solver's device."""
        return torch.as_tensor(self._naive_form(src, tx, ty),
                               device=self.device)

    def _apply(self, src_curve, density, tx, ty):
        raise NotImplementedError

    def _apply_raw(self, sx, sy, weighted, tx, ty):
        """Kernel apply on raw source tensors (weights already folded into
        ``weighted``); backs the stratified-subsampling paths."""
        raise NotImplementedError

    def _apply_merged(self, sigma_g, tx, ty):
        raise NotImplementedError

    def _grid_symbol(self) -> np.ndarray:
        raise NotImplementedError

    def _prepare_grid_rhs(self, fc):
        return fc

    # -- main ---------------------------------------------------------------
    def __call__(self, f: EmbeddedFunction, tol: float = 1e-12,
                 maxiter: int = 200, restart: int = 40,
                 verbose: bool = False) -> EmbeddedFunction:
        ue, _ = self.solve_with_stats(f, tol=tol, maxiter=maxiter,
                                      restart=restart, verbose=verbose)
        return ue

    def solve_with_stats(self, f: EmbeddedFunction, tol: float = 1e-12,
                         maxiter: int = 200, restart: int = 40,
                         verbose: bool = False):
        """Full solve, also returning {'annular_iterations': [B ints],
        'annular_residuals': [B floats]} (reference analogue:
        iteration_counts, multi_boundary/scalar.py:102).  The annular solves
        raise when GMRES ends with its true residual above tol (see
        AnnularScalarSolver.solve_with_stats for the default of 1e-12)."""
        ebdyc = self.ebdyc
        fft_plan = ebdyc.fft_plan
        fc = self._prepare_grid_rhs(f.grid * ebdyc.grid_step_dev)
        uch = fft_plan.fft2(fc) * self._symbol
        uc = fft_plan.ifft2_real(uch)
        if self.solver_type == "fourth":
            # 4th-order FD derivatives + 3rd-order polynomial interface
            # interpolation (reference: multi_boundary/scalar.py:89-95)
            g, pi = ebdyc.grid, self.ifc_poly_interp
            bvs, bxs, bys = (pi(uc), pi(fd_x_4(uc, g.xh)),
                             pi(fd_y_4(uc, g.yh)))
        else:
            # interface values + gradients from the mode array
            vals, gxs, gys = ebdyc.interface_values_and_grads(uch[None])
            bvs, bxs, bys = vals[0], gxs[0], gys[0]
        bvl = ebdyc.v2l(bvs)
        bxl = ebdyc.v2l(bxs)
        byl = ebdyc.v2l(bys)
        # per-boundary annular solves + densities: one lockstep GMRES when
        # every boundary has the same (M, n), else one after another
        dims = {(h.annular_solver.M, h.annular_solver.n)
                for h in self.helpers}
        if len(self.helpers) > 1 and len(dims) == 1:
            urs, bstats = batched_annular_solve(
                [h.annular_solver for h in self.helpers],
                [h.metric for h in self.helpers],
                [h.annular_rhs(fr) for h, fr in zip(self.helpers, f.radials)],
                tol, maxiter, restart)
            for h, it in zip(self.helpers, bstats["iterations"]):
                h.iterations_last_call = it
            sig_gs, sig_rs = map(list, zip(*(
                h.densities(ur, bv, bx, by)
                for h, ur, bv, bx, by in zip(self.helpers, urs, bvl, bxl,
                                             byl))))
            stats = {"annular_iterations": bstats["iterations"],
                     "annular_residuals": bstats["residual"]}
        else:
            urs, sig_gs, sig_rs, stats_list = [], [], [], []
            for h, fr, bv, bx, by in zip(self.helpers, f.radials, bvl, bxl,
                                         byl):
                ur, sg, sr, st = h.solve_and_densities(fr, bv, bx, by, tol,
                                                       maxiter, restart)
                urs.append(ur)
                sig_gs.append(sg)
                sig_rs.append(sr)
                stats_list.append(st)
            stats = {"annular_iterations": [s["iterations"]
                                            for s in stats_list],
                     "annular_residuals": [s["residual"]
                                           for s in stats_list]}
        self.iteration_counts = list(stats["annular_iterations"])
        if verbose:
            print("annular iterations:", self.iteration_counts)
        # global layer evaluation onto pna + interfaces
        sigma_g = torch.cat(sig_gs)
        if self.grid_backend == "fft":
            phi = self.grid_eval(sigma_g * self.grid_src_w)
            uc = uc + torch.where(self._pna_mask, phi, 0.0)
            bus = ebdyc.v2l(self._apply_merged(
                sigma_g, ebdyc.all_interface_x_dev,
                ebdyc.all_interface_y_dev))
        else:
            out = self._apply_merged(sigma_g, self._dense_tx, self._dense_ty)
            n_pna = ebdyc.pna_x.size
            uc = add_flat(uc.reshape(-1), self._pna_flat, out[:n_pna])\
                .reshape(ebdyc.grid.shape)
            bus = ebdyc.v2l(out[n_pna:])
        # per-boundary radial corrections
        urs = [h.correct(self, ur, sg, sr, bu)
               for h, ur, sg, sr, bu in
               zip(self.helpers, urs, sig_gs, sig_rs, bus)]
        # merge radial solutions onto the grid, mask physical
        uc = ebdyc.interpolate_radial_to_grid(urs, uc)
        uc = uc * ebdyc.phys_dev
        return EmbeddedFunction(uc, urs), stats

    # -- boundary data extraction --------------------------------------------
    def get_boundary_values(self, ue: EmbeddedFunction) -> BoundaryFunction:
        return BoundaryFunction([h.f_to_bdy @ fr
                                 for h, fr in zip(self.helpers, ue.radials)])

    def get_boundary_normal_derivatives(self, ue) -> BoundaryFunction:
        return BoundaryFunction([h.dn_to_bdy @ fr
                                 for h, fr in zip(self.helpers, ue.radials)])


class PoissonSolver(ScalarSolver):
    """lap u = f (reference: ipde/solvers/multi_boundary/poisson.py)."""

    def __init__(self, ebdyc, **kw):
        if ebdyc.bumpy is None:
            ebdyc.ready_bump()
        super().__init__(ebdyc, **kw)

    def _make_grid_evaluator(self, gx, gy):
        return FreespaceGridEvaluator(self.ebdyc.grid, gx, gy,
                                      kernel="laplace",
                                      target_bounds=self.ebdyc.phys_bounds(),
                                      target_hull=self.ebdyc.phys_extremes(),
                                      device=self.device)

    def _make_annular_solver(self, geom):
        return AnnularPoissonSolver(geom, device=self.device)

    def _annular_solver_signature(self):
        return ("AnnularPoissonSolver", 0.0)

    def _make_qfs(self, curve, source, interior, build_u2s: bool = True):
        return laplace_qfs(curve, source, interior, build_u2s=build_u2s,
                           device=self.device)

    def _make_qfs_slp_only(self, curve, source, interior):
        return laplace_qfs(curve, source, interior, slp=True, dlp=False,
                           device=self.device)

    def _naive_form(self, src, tx, ty):
        return sq.laplace_slp_naive(src, tx, ty)

    def _apply(self, src_curve, density, tx, ty):
        d = src_curve.dev(self.device)
        return kernels.laplace_slp_apply(d["x"], d["y"],
                                         density * d["weights"], tx, ty)

    def _apply_raw(self, sx, sy, weighted, tx, ty):
        return kernels.laplace_slp_apply(sx, sy, weighted, tx, ty)

    def _apply_merged(self, sigma_g, tx, ty):
        return kernels.laplace_slp_apply(self.grid_src_x, self.grid_src_y,
                                         sigma_g * self.grid_src_w, tx, ty)

    def _grid_symbol(self):
        lap = self.ebdyc.lap.copy()
        lap[0, 0] = np.inf
        return 1.0 / lap

    def _prepare_grid_rhs(self, fc):
        return self.ebdyc.demean_function(fc)


class ModifiedHelmholtzSolver(ScalarSolver):
    """(k^2 - lap) u = f (reference: multi_boundary/modified_helmholtz.py).

    NOTE the sign convention: the grid solve inverts (k^2 - lap) directly,
    so ``f`` is the right-hand side of (k^2 - lap) u = f.
    """

    def __init__(self, ebdyc, k: float, **kw):
        self.k = float(k)
        super().__init__(ebdyc, **kw)

    def _qfs_alpha(self, ebdy):
        """Yukawa at high k needs a larger source shift: the K0(k r)
        quadrature tail scales with k * shift; clipped to [1.5, 3]
        (ipde_tpu/solvers/scalar.py ModifiedHelmholtzSolver._qfs_alpha)."""
        return float(np.clip(1.5 + 0.5 * self.k * 2.0 * np.pi
                             / ebdy.bdy.N, 1.5, 3.0))

    def _make_grid_evaluator(self, gx, gy):
        return FreespaceGridEvaluator(self.ebdyc.grid, gx, gy,
                                      kernel="yukawa", kappa=self.k,
                                      target_bounds=self.ebdyc.phys_bounds(),
                                      target_hull=self.ebdyc.phys_extremes(),
                                      device=self.device)

    def _make_annular_solver(self, geom):
        return AnnularModifiedHelmholtzSolver(geom, k=self.k,
                                              device=self.device)

    def _annular_solver_signature(self):
        return ("AnnularModifiedHelmholtzSolver", self.k)

    def _make_qfs(self, curve, source, interior, build_u2s: bool = True):
        return mh_qfs(curve, source, interior, self.k, build_u2s=build_u2s,
                      device=self.device)

    def _make_qfs_slp_only(self, curve, source, interior):
        return mh_qfs(curve, source, interior, self.k, slp=True, dlp=False,
                      device=self.device)

    def _naive_form(self, src, tx, ty):
        return sq.mh_slp_naive(src, tx, ty, self.k)

    def _apply(self, src_curve, density, tx, ty):
        d = src_curve.dev(self.device)
        return kernels.mh_slp_apply(d["x"], d["y"], density * d["weights"],
                                    tx, ty, self.k)

    def _apply_raw(self, sx, sy, weighted, tx, ty):
        return kernels.mh_slp_apply(sx, sy, weighted, tx, ty, self.k)

    def _apply_merged(self, sigma_g, tx, ty):
        return kernels.mh_slp_apply(self.grid_src_x, self.grid_src_y,
                                    sigma_g * self.grid_src_w, tx, ty, self.k)

    def _grid_symbol(self):
        return 1.0 / (self.k**2 - self.ebdyc.lap)
