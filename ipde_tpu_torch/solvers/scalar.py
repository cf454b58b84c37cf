"""Inhomogeneous scalar solvers (Poisson, modified Helmholtz) on an
embedded-boundary domain.

The solve path (reference: ipde/solvers/multi_boundary/scalar.py:72-117,
internals/scalar.py:68-116, multi_boundary/poisson.py,
modified_helmholtz.py):

  1. periodic box solve of the rolled-off forcing (torch.fft + symbol),
  2. spectral interpolation of (u, ux, uy) to all interfaces (exact
     trigonometric evaluation of the mode array),
  3. per boundary: annular strip solve with zero BCs (GMRES),
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

import numpy as np
import torch

from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import kernels, singular as sq
from ipde_tpu_torch.ops.grid_eval import FreespaceGridEvaluator
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.qfs.qfs import QFSEvaluator, laplace_qfs, mh_qfs
from ipde_tpu_torch.solvers.annular_scalar import (
    AnnularModifiedHelmholtzSolver, AnnularPoissonSolver)


class _ScalarHelper:
    """Per-boundary machinery: annular solver + QFS maps + estimator rows."""

    def __init__(self, solver, ebdy: EmbeddedBoundary):
        self.ebdy = ebdy
        self.interior = ebdy.interior
        dev = solver.device
        geom = AnnularGeometry(ebdy.bdy.N, ebdy.M, ebdy.lb, ebdy.ub,
                               ebdy.approximate_radius)
        self.geom = geom
        self.annular_solver = solver._make_annular_solver(geom)
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

    grid_backend: 'fft' (the default) evaluates the sigma_g layer potential
    on the grid with the free-space FFT evaluator; 'dense' uses the direct
    kernel sum onto every physical-not-in-annulus grid point.  solver_type:
    only 'spectral' is ported.  Reference analogue: grid_backend selection in
    ipde/solvers/multi_boundary/poisson.py:39-64.
    """

    def __init__(self, ebdyc: EmbeddedBoundaryCollection,
                 grid_backend: str = "fft",
                 solver_type: str = "spectral"):
        self.ebdyc = ebdyc
        if ebdyc.grid is None:
            raise ValueError("collection has no registered grid")
        if grid_backend not in ("fft", "dense"):
            raise ValueError(grid_backend)
        if solver_type == "fourth":
            raise NotImplementedError(
                "solver_type='fourth' is not ported to ipde_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 16)")
        if solver_type != "spectral":
            raise ValueError(solver_type)
        self.device = ebdyc.device
        self.grid_backend = grid_backend
        self.solver_type = solver_type
        self.helpers = [_ScalarHelper(self, e) for e in ebdyc]
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
        # interface values + gradients from the mode array
        vals, gxs, gys = ebdyc.interface_values_and_grads(uch[None])
        bvl = ebdyc.v2l(vals[0])
        bxl = ebdyc.v2l(gxs[0])
        byl = ebdyc.v2l(gys[0])
        # per-boundary annular solves + densities
        urs, sig_gs, sig_rs, stats_list = [], [], [], []
        for h, fr, bv, bx, by in zip(self.helpers, f.radials, bvl, bxl, byl):
            ur, sg, sr, st = h.solve_and_densities(fr, bv, bx, by, tol,
                                                   maxiter, restart)
            urs.append(ur)
            sig_gs.append(sg)
            sig_rs.append(sr)
            stats_list.append(st)
        stats = {"annular_iterations": [s["iterations"] for s in stats_list],
                 "annular_residuals": [s["residual"] for s in stats_list]}
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
            uc = uc.reshape(-1).index_add(0, self._pna_flat, out[:n_pna])\
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
