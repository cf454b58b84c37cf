"""Inhomogeneous Stokes solver on an embedded-boundary domain.

Solves  -lap u + grad p = f,  div u = 0  (mu = 1).
Reference: ipde/solvers/multi_boundary/vector.py:57-112, stokes.py,
internals/vector.py:63-162, internals/stokes.py; the orchestration of
ipde_tpu.solvers.vector:
  1. box solve by spectral pressure projection of the rolled-off forcing
     (one batched torch.fft of the two forcing fields, one of (u, v, p)),
  2. values and gradients of (u, v, p) at the interface from one 3-field
     exact evaluation of the mode stack (``solver_type="spectral"``) or by
     4th-order finite differences on the grid and 3rd-order polynomial
     interpolation (``solver_type="fourth"``); the grid solution's traction
     there,
  3. per boundary: annular Stokes solve (zero velocity BCs; one lockstep
     GMRES over all boundaries when they share one (M, n)), interface
     traction of the radial solution; SLP density = traction jump, DLP
     density = grid velocity, both negated for an inclusion; QFS ->
     sigma_g (grid side), sigma_r (radial side),
  4. one Stokeslet evaluation (u, v, p) of the merged sigma_g onto every
     physical-not-in-annulus grid point (``grid_backend="fft"``, the
     default: the free-space FFT evaluator of ``ops/grid_eval.py`` on the
     whole grid; ``"dense"``: the CUDA kernel) and all interfaces (CUDA
     kernel),
  5. per boundary the radial correction: with several boundaries the
     other boundaries' field at the interface (the merged field less its
     own sigma_g's) is re-matched into sigma_r by the u2s map; sigma_r onto
     the radial grid (CUDA kernel), the interface pressure reconciliation
     per strip and the radial->grid merge.

Ported: one interior boundary plus any number of inclusions
(``interior=False``), both grid backends, ``helpers=`` reuse, both
solver types, ``use_mesh`` (step 4's kernel apply target-sharded over a
mesh, step 3's lockstep GMRES split along its boundary axis) and both
setup backends of the QFS maps (``stokes_qfs``; qfs/qfs.py).
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
from ipde_tpu_torch.ops import forms_dev as fd
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.ops.fd import fd_x_4, fd_y_4
from ipde_tpu_torch.ops.fourier import FourierPlan1D
from ipde_tpu_torch.ops.grid_eval import StokesFreespaceGridEvaluator
from ipde_tpu_torch.ops.interp import PolyInterpolator2D
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.parallel.sharded import (Mesh, check_lead,
                                             sharded_stokes_slp_apply)
from ipde_tpu_torch.qfs.qfs import QFSEvaluator, auto_backend
from ipde_tpu_torch.solvers.annular_stokes import (AnnularStokesSolver,
                                                   batched_stokes_solve)
from ipde_tpu_torch.utils.profiling import spanned


@spanned("setup.qfs")
def stokes_qfs(curve, source, interior: bool, slp: bool = True,
               dlp: bool = True, rcond: float = 1e-15,
               build_u2s: bool = True, backend: str = None, *,
               device) -> QFSEvaluator:
    """QFS maps for the Stokes velocity layer potentials (2-vector packed);
    backend None: ``auto_backend(curve.N, device)``.

    The source-to-curve matrix carries the rank-1 normal-flux completion
    (reference: Fixed_SLP in examples/multi_stokes_for_paper.py) so the
    least-squares match is well posed; matched data is incompressible, so
    the completion component of the solution vanishes."""
    backend = backend or auto_backend(curve.N, device)
    b = fd.FormBuilders(backend, device)
    jump = -0.5 if interior else 0.5
    forms = []
    if slp:
        forms.append(b.form("stokes_slp_self")(curve))
    if dlp:
        forms.append(b.form("stokes_dlp_self")(curve)
                     + jump * b.eye(2 * curve.N))
    A = (b.form("stokes_slp_naive")(source, curve.x, curve.y)
         + b.form("stokes_pressure_fix")(source, curve.normal_x,
                                         curve.normal_y))
    return QFSEvaluator(source, curve, forms, A, rcond, build_u2s=build_u2s,
                        backend=backend, device=device)


def _stokes_donor(prev_helper, ebdy):
    """The previous helper's annular Stokes solver, if its geometry still
    fits (``AnnularGeometry.fits``)."""
    if prev_helper is None or not prev_helper.annular_solver.geom.fits(ebdy):
        return None
    return prev_helper.annular_solver


class _StokesHelper:
    """Per-boundary machinery of a StokesSolver: annular solver, QFS maps,
    estimator rows, radial derivative operators; with ``multi`` (several
    boundaries) also the values->source map of qfs_r and the own grid
    source -> own interface Stokeslet matrix that the correction needs."""

    def __init__(self, solver, ebdy: EmbeddedBoundary, multi: bool = True,
                 shared_annular=None):
        self.ebdy = ebdy
        self.interior = ebdy.interior
        dev = solver.device
        geom = AnnularGeometry(ebdy.bdy.N, ebdy.M, ebdy.lb, ebdy.ub,
                               ebdy.approximate_radius)
        self.annular_solver = (
            shared_annular if shared_annular is not None
            else AnnularStokesSolver(geom, mu=1.0, device=dev))
        self.metric = AnnularMetric(ebdy.bdy.speed, ebdy.bdy.curvature, geom)
        ifc = ebdy.interface
        self.grid_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=self.interior)
        self.radial_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=not self.interior)
        self.qfs_g = stokes_qfs(ifc, self.grid_source, self.interior,
                                build_u2s=False, device=dev)
        self.qfs_r = stokes_qfs(ifc, self.radial_source, not self.interior,
                                build_u2s=multi, device=dev)
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                        device=dev)
        # the one-boundary correction needs neither (the shortcut in
        # `correct`)
        self.own_src_to_ifc = None
        if multi:
            slp = fd.FormBuilders(auto_backend(ifc.N, dev), dev).form(
                "stokes_slp_naive")
            self.own_src_to_ifc = torch.as_tensor(
                slp(self.grid_source, ifc.x, ifc.y), device=dev)
        # estimator rows + radial derivative machinery
        self.f_to_bdy = f64(ebdy.interp_f_to_bdy)
        self.f_to_ifc = f64(ebdy.interp_f_to_interface)
        self.D00 = f64(ebdy.D00)
        self.plan_t = FourierPlan1D(ebdy.bdy.N, device=dev)
        self.inv_rspeed = f64(ebdy.inverse_radial_speed)
        self.rspeed = f64(ebdy.radial_speed)
        b = ebdy.bdy
        self.nx, self.ny = f64(b.normal_x), f64(b.normal_y)
        self.tx, self.ty = f64(b.tangent_x), f64(b.tangent_y)
        self.ifc_n = (f64(ifc.normal_x), f64(ifc.normal_y))
        # stratified source subsampling for the dense radial Stokeslet
        # apply in `correct` (rows far from the source curve need fewer
        # sources)
        self.radial_plan = StratifiedRadialApply(
            self.radial_source, ebdy.radial_x, ebdy.radial_y,
            k_density=ebdy.bdy.N // 2, device=dev)
        self.annular_solver.make_ops(self.metric)   # warm the ops cache
        self.zero_bc = torch.zeros(ebdy.bdy.N, dtype=torch.float64,
                                   device=dev)

    # -- coordinate conversions (reference: embedded_boundary.py:521-530) ----
    def uv_to_rt(self, fu, fv):
        return fu * self.nx + fv * self.ny, fu * self.tx + fv * self.ty

    def rt_to_uv(self, fr, ft):
        return fr * self.nx + ft * self.tx, fr * self.ny + ft * self.ty

    # -- traction on the radial grid (reference: internals/vector.py:87-102) -
    def _traction_rt(self, Ur, Ut, p, row):
        Urr = self.D00 @ Ur
        Urt = self.plan_t.tderiv(Ur) * self.inv_rspeed
        Utr = self.rspeed * (self.D00 @ (Ut * self.inv_rspeed))
        Tr = 2 * (row @ Urr) - row @ p
        Tt = row @ Utr + row @ Urt
        return Tr, Tt

    def interface_traction_uv(self, u, v, p):
        Ur, Ut = self.uv_to_rt(u, v)
        return self.rt_to_uv(*self._traction_rt(Ur, Ut, p, self.f_to_ifc))

    def boundary_traction_uv(self, u, v, p):
        Ur, Ut = self.uv_to_rt(u, v)
        return self.rt_to_uv(*self._traction_rt(Ur, Ut, p, self.f_to_bdy))

    # -- main per-boundary step ----------------------------------------------
    def annular_rhs(self, fur, fvr):
        """The flat zero-BC annular right-hand side (batched path)."""
        z = self.zero_bc
        return self.annular_solver.build_rhs(*self.uv_to_rt(fur, fvr), z, z,
                                             z, z)

    def densities(self, uvp_rt, bu, bv, btxx, btxy, btyy):
        """QFS effective densities from the (r, t, p) annular solution +
        interface data (the non-GMRES half of solve_and_densities)."""
        rr, tr, pr = uvp_rt
        nix, niy = self.ifc_n
        btx = btxx * nix + btxy * niy
        bty = btxy * nix + btyy * niy
        ur, vr = self.rt_to_uv(rr, tr)
        rtx, rty = self.interface_traction_uv(ur, vr, pr)
        taus = torch.cat([rtx - btx, rty - bty])
        taud = torch.cat([bu, bv])
        if not self.interior:
            taus, taud = -taus, -taud
        sigma_g = self.qfs_g([taus, taud])
        sigma_r = self.qfs_r([taus, taud])
        return (ur, vr, pr), sigma_g, sigma_r

    @property
    def iterations_last_call(self) -> int:
        """The GMRES iterations of this boundary's last annular solve (its
        annular solver's; set from the host read at the end of GMRES, at
        every replay of a planified call too)."""
        return self.annular_solver.iterations_last_call

    def solve_and_densities(self, fur, fvr, bu, bv, btxx, btxy, btyy,
                            tol, maxiter, restart):
        fr, ft = self.uv_to_rt(fur, fvr)
        z = self.zero_bc
        uvp_rt, stats = self.annular_solver.solve_with_stats(
            self.metric, fr, ft, z, z, z, z, tol=tol, maxiter=maxiter,
            restart=restart)
        uvp, sigma_g, sigma_r = self.densities(uvp_rt, bu, bv, btxx, btxy,
                                               btyy)
        return uvp, sigma_g, sigma_r, stats

    def correct(self, uvp, sigma_g, sigma_r, bu, bv, single: bool):
        """Add the radial-side field on the radial grid.  With several
        boundaries (not ``single``), the merged grid-side velocity (bu, bv)
        at this interface less this boundary's own sigma_g field is the
        other boundaries' field, re-matched into sigma_r by the u2s map."""
        ur, vr, pr = uvp
        if single:
            sigma_r_tot = sigma_r
        else:
            N = self.ebdy.bdy.N
            w = self.own_src_to_ifc @ sigma_g
            sigma_r_tot = sigma_r + self.qfs_r.u2s(
                torch.cat([bu - w[:N], bv - w[N:]]))
        sN = self.radial_source.N
        du, dv, dp = self.radial_plan.apply(
            lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                sx, sy, sigma_r_tot[:sN][::f] * ws,
                sigma_r_tot[sN:][::f] * ws, tx, ty),
            n_out=3)
        return ur + du, vr + dv, pr + dp


class StokesSolver:
    """(u, v, p) = solver(fu, fv) with fu, fv EmbeddedFunctions; tensors on
    the collection's device.

    The collection holds one interior boundary and any number of inclusions
    (``interior=False``).  grid_backend: 'fft' (the default) evaluates the
    merged sigma_g Stokeslet field on the grid with the free-space FFT
    evaluator; 'dense' sums it directly onto every physical-not-in-annulus
    grid point.  helpers: the helpers of a previous StokesSolver on
    compatible geometry (same n, M, radial bounds, about the same radius):
    their annular Stokes solvers and preconditioners are reused.
    solver_type: 'spectral' (interface data from the mode stack) or
    'fourth' (4th-order FD grid derivatives and 3rd-order polynomial
    interface interpolation; reference:
    ipde/solvers/multi_boundary/vector.py:7-47).  GMRES tol: the annular
    solve checks the TRUE residual and raises above tol; its float64 floor
    is about 6.5e-14 here, so the default is 1e-12.
    """

    @spanned("setup.solver")
    def __init__(self, ebdyc: EmbeddedBoundaryCollection,
                 grid_backend: str = "fft", helpers: Optional[List] = None,
                 solver_type: str = "spectral"):
        self.ebdyc = ebdyc
        if ebdyc.grid is None:
            raise ValueError("collection has no registered grid")
        if grid_backend not in ("fft", "dense"):
            raise ValueError(grid_backend)
        if solver_type not in ("spectral", "fourth"):
            raise ValueError(solver_type)
        if ebdyc.bumpy is None:
            ebdyc.ready_bump()
        self.device = ebdyc.device
        self.grid_backend = grid_backend
        self.solver_type = solver_type
        if solver_type == "fourth":
            g = ebdyc.grid
            self.ifc_poly_interp = PolyInterpolator2D(
                g.x_bounds[0], g.y_bounds[0], g.xh, g.yh, g.Nx, g.Ny,
                ebdyc.all_interface_x, ebdyc.all_interface_y, order=3,
                device=self.device)
        multi = len(ebdyc.ebdys) > 1
        donors = list(helpers or [])
        donors += [None] * (len(ebdyc.ebdys) - len(donors))
        self.helpers = [_StokesHelper(self, e, multi=multi,
                                      shared_annular=_stokes_donor(d, e))
                        for e, d in zip(ebdyc, donors)]
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                        device=self.device)
        self.grid_src_x = f64(np.concatenate(
            [h.grid_source.x for h in self.helpers]))
        self.grid_src_y = f64(np.concatenate(
            [h.grid_source.y for h in self.helpers]))
        self.grid_src_w = f64(np.concatenate(
            [h.grid_source.weights for h in self.helpers]))
        self.src_Ns = [h.grid_source.N for h in self.helpers]
        lap = ebdyc.lap.copy()
        lap[0, 0] = np.inf
        self.ilap = f64(1.0 / lap)
        self.ikx = 1j * ebdyc.kx_dev
        self.iky = 1j * ebdyc.ky_dev
        if grid_backend == "fft":
            self.grid_eval = self._make_grid_evaluator(
                np.concatenate([h.grid_source.x for h in self.helpers]),
                np.concatenate([h.grid_source.y for h in self.helpers]))
            self._pna_mask = torch.as_tensor(ebdyc.phys_not_in_annulus,
                                             device=self.device)
        else:
            self._dense_tx = torch.cat([ebdyc.pna_x_dev,
                                        ebdyc.all_interface_x_dev])
            self._dense_ty = torch.cat([ebdyc.pna_y_dev,
                                        ebdyc.all_interface_y_dev])
        self._mesh = None
        self._one_device = Mesh([self.device])

    def use_mesh(self, mesh):
        """Shard over ``mesh`` (a ``parallel.sharded.Mesh`` whose lead is
        the collection's device; None: back to one device): the merged
        sigma_g Stokeslet apply runs target-sharded and the lockstep
        annular GMRES of same-shape boundaries splits its boundary axis
        over the mesh.  The radial corrections keep their stratified plans
        and ``StokesDirichletBIE`` stays on one device, as in ipde_tpu; the
        box FFT solve and the FFT grid evaluators stay on ``mesh.lead``
        (cuFFT on one card)."""
        self._mesh = check_lead(mesh, self.device)

    @property
    def iteration_counts(self):
        """Per boundary, the GMRES iterations of the last solve (reference:
        multi_boundary/scalar.py:102), as ints: read on the host at the end
        of each GMRES, at every replay of a planified call too."""
        return [h.iterations_last_call for h in self.helpers]

    @property
    def _shards(self) -> Mesh:
        """What the kernel applies run over: ``use_mesh``'s mesh, else one
        shard on the solver's device."""
        return self._mesh or self._one_device

    def _apply_stokes(self, sx, sy, wfx, wfy, tx, ty):
        """The Stokeslet apply, target-sharded over ``_shards``."""
        return sharded_stokes_slp_apply(self._shards, sx, sy, wfx, wfy, tx,
                                        ty)

    def _make_grid_evaluator(self, gx, gy) -> StokesFreespaceGridEvaluator:
        """The Stokeslet FFT evaluator for sources (gx, gy), truncated for
        the physical grid points."""
        return StokesFreespaceGridEvaluator(
            self.ebdyc.grid, gx, gy, target_bounds=self.ebdyc.phys_bounds(),
            target_hull=self.ebdyc.phys_extremes(), device=self.device,
            padded=bool(self.ebdyc.pad_quantum))

    def __call__(self, fu: EmbeddedFunction, fv: EmbeddedFunction,
                 tol: float = 1e-12, maxiter: int = 200, restart: int = 50,
                 verbose: bool = False):
        (u, v, p), _ = self.solve_with_stats(fu, fv, tol=tol, maxiter=maxiter,
                                             restart=restart, verbose=verbose)
        return u, v, p

    def solve_with_stats(self, fu: EmbeddedFunction, fv: EmbeddedFunction,
                         tol: float = 1e-12, maxiter: int = 200,
                         restart: int = 50, verbose: bool = False):
        """Full Stokes solve, also returning {'annular_iterations': [0-d
        int64 tensors], 'annular_residuals': [0-d float64 tensors]} on the
        solver's device, read by the caller after the call.  Once warm, the
        solve makes no host sync and no host-to-device copy but GMRES's
        status reads.  The annular solve raises when GMRES ends with its
        true residual above tol."""
        ebdyc = self.ebdyc
        plan = ebdyc.fft_plan
        fuc = ebdyc.demean_function(fu.grid * ebdyc.grid_step_dev)
        fvc = ebdyc.demean_function(fv.grid * ebdyc.grid_step_dev)
        fuh, fvh = plan.fft2_stack([fuc, fvc])
        # pressure projection: p = ilap (ikx fu + iky fv); u = ilap(ikx p - fu)
        ph = (self.ikx * fuh + self.iky * fvh) * self.ilap
        uh = (self.ikx * ph - fuh) * self.ilap
        vh = (self.iky * ph - fvh) * self.ilap
        stack3 = torch.stack([uh, vh, ph])
        uc, vc, pc = plan.ifft2_real_stack(stack3)
        if self.solver_type == "fourth":
            # 4th-order FD derivatives + 3rd-order polynomial interface
            # interpolation (reference: multi_boundary/vector.py:7-47)
            g, pi = ebdyc.grid, self.ifc_poly_interp
            vals = [pi(uc), pi(vc), pi(pc)]
            gxs = [pi(fd_x_4(uc, g.xh)), pi(fd_x_4(vc, g.xh))]
            gys = [pi(fd_y_4(uc, g.yh)), pi(fd_y_4(vc, g.yh))]
        else:
            # values + gradients of (u, v, p) at the interface in one pass
            vals, gxs, gys = ebdyc.interface_values_and_grads(stack3)
        bps = vals[2]
        btxxs = 2 * gxs[0] - bps
        btxys = gys[0] + gxs[1]
        btyys = 2 * gys[1] - bps
        v2l = ebdyc.v2l
        ifc_data = list(zip(v2l(vals[0]), v2l(vals[1]), v2l(btxxs),
                            v2l(btxys), v2l(btyys)))
        # per-boundary annular solves + densities: one lockstep GMRES when
        # every boundary has the same (M, n), else one after another
        dims = {(h.annular_solver.M, h.annular_solver.n)
                for h in self.helpers}
        if len(self.helpers) > 1 and len(dims) == 1:
            uvp_rts, bstats = batched_stokes_solve(
                [h.annular_solver for h in self.helpers],
                [h.metric for h in self.helpers],
                [h.annular_rhs(fur, fvr) for h, fur, fvr in
                 zip(self.helpers, fu.radials, fv.radials)],
                tol, maxiter, restart, self._shards)
            uvps, sig_gs, sig_rs = map(list, zip(*(
                h.densities(uvp_rt, *d)
                for h, uvp_rt, d in zip(self.helpers, uvp_rts, ifc_data))))
            stats = {"annular_iterations": bstats["iterations"],
                     "annular_residuals": bstats["residual"]}
        else:
            uvps, sig_gs, sig_rs, stats_list = [], [], [], []
            for h, fur, fvr, d in zip(self.helpers, fu.radials, fv.radials,
                                      ifc_data):
                uvp, sg, sr, st = h.solve_and_densities(
                    fur, fvr, *d, tol, maxiter, restart)
                uvps.append(uvp)
                sig_gs.append(sg)
                sig_rs.append(sr)
                stats_list.append(st)
            stats = {"annular_iterations": [s["iterations"]
                                            for s in stats_list],
                     "annular_residuals": [s["residual"]
                                           for s in stats_list]}
        if verbose:
            print("annular Stokes iterations:", self.iteration_counts)
        # merged sigma_g evaluation onto pna + interfaces
        wfx = torch.cat([s[:n] for s, n in zip(sig_gs, self.src_Ns)])
        wfy = torch.cat([s[n:] for s, n in zip(sig_gs, self.src_Ns)])
        wfx, wfy = wfx * self.grid_src_w, wfy * self.grid_src_w
        if self.grid_backend == "fft":
            uc, vc, pc = (c + torch.where(self._pna_mask, g, 0.0)
                          for c, g in zip((uc, vc, pc),
                                          self.grid_eval(wfx, wfy)))
            giu, giv, gip = self._apply_stokes(
                self.grid_src_x, self.grid_src_y, wfx, wfy,
                ebdyc.all_interface_x_dev, ebdyc.all_interface_y_dev)
        else:
            gu, gv, gp = self._apply_stokes(
                self.grid_src_x, self.grid_src_y, wfx, wfy, self._dense_tx,
                self._dense_ty)
            idx = ebdyc.pna_flat_dev
            n_pna = idx.numel()
            uc, vc, pc = (add_flat(c.reshape(-1), idx, g[:n_pna])
                          .reshape(c.shape) for c, g in ((uc, gu), (vc, gv),
                                                         (pc, gp)))
            giu, giv, gip = gu[n_pna:], gv[n_pna:], gp[n_pna:]
        # grid-side pressure at the interfaces (FFT solution + sigma_g field)
        bpl = v2l(bps + gip)
        single = len(self.helpers) == 1
        out = [h.correct(uvp, sg, sr, bu, bv, single)
               for h, uvp, sg, sr, bu, bv in zip(self.helpers, uvps, sig_gs,
                                                 sig_rs, v2l(giu), v2l(giv))]
        urs = [o[0] for o in out]
        vrs = [o[1] for o in out]
        # Stokes pressure is only defined up to a constant per region: the
        # annular and grid solves each pin their own; reconcile each strip
        # by matching the mean pressure across its interface (as ipde_tpu
        # does; the reference leaves the mismatch,
        # internals/vector.py:134-141)
        prs = [o[2] + (bp - h.f_to_ifc @ o[2]).mean()
               for h, o, bp in zip(self.helpers, out, bpl)]
        uc, vc, pc = ebdyc.interpolate_radial_to_grid_many(
            [urs, vrs, prs], [uc, vc, pc])
        phys = ebdyc.phys_dev
        return (EmbeddedFunction(uc * phys, urs),
                EmbeddedFunction(vc * phys, vrs),
                EmbeddedFunction(pc * phys, prs)), stats

    def get_boundary_values(self, ue: EmbeddedFunction) -> BoundaryFunction:
        return BoundaryFunction([h.f_to_bdy @ fr
                                 for h, fr in zip(self.helpers, ue.radials)])

    def get_boundary_tractions(self, u, v, p):
        """Per-boundary (tx, ty) traction of (u, v, p) on the true boundary
        (reference: multi_boundary/vector.py get_boundary_tractions)."""
        return [h.boundary_traction_uv(ur, vr, pr)
                for h, ur, vr, pr in zip(self.helpers, u.radials, v.radials,
                                         p.radials)]
