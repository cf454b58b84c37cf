"""Inhomogeneous Stokes solver on an embedded-boundary domain.

Solves  -lap u + grad p = f,  div u = 0  (mu = 1).
Reference: ipde/solvers/multi_boundary/vector.py:57-112, stokes.py,
internals/vector.py:63-162, internals/stokes.py; the orchestration of
ipde_tpu.solvers.vector:
  1. box solve by spectral pressure projection of the rolled-off forcing
     (one batched torch.fft of the two forcing fields, one of (u, v, p)),
  2. values and gradients of (u, v, p) at the interface from one 3-field
     exact evaluation of the mode stack; the grid solution's traction there,
  3. annular Stokes solve (zero velocity BCs), interface traction of the
     radial solution; SLP density = traction jump, DLP density = grid
     velocity; QFS -> sigma_g (grid side), sigma_r (radial side),
  4. one Stokeslet evaluation (u, v, p) of sigma_g onto every
     physical-not-in-annulus grid point and the interface (CUDA kernel),
  5. the radial correction (sigma_r onto the radial grid, CUDA kernel), the
     interface pressure reconciliation and the radial->grid merge.

Ported: one interior boundary, ``grid_backend="dense"`` (the default) and
``solver_type="spectral"``.  ``grid_backend="fft"``, ``solver_type="fourth"``
and any other collection (several boundaries, an exterior one) raise
NotImplementedError naming their ROADMAP.md items.
"""

from __future__ import annotations

import numpy as np
import torch

from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.geometry.annular import AnnularGeometry, AnnularMetric
from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.ops.fourier import FourierPlan1D
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.qfs.qfs import QFSEvaluator
from ipde_tpu_torch.solvers.annular_stokes import AnnularStokesSolver


def stokes_qfs(curve, source, interior: bool, slp: bool = True,
               dlp: bool = True, rcond: float = 1e-15,
               build_u2s: bool = True, *, device) -> QFSEvaluator:
    """QFS maps for the Stokes velocity layer potentials (2-vector packed),
    composed on the host.

    The source-to-curve matrix carries the rank-1 normal-flux completion
    (reference: Fixed_SLP in examples/multi_stokes_for_paper.py) so the
    least-squares match is well posed; matched data is incompressible, so
    the completion component of the solution vanishes."""
    jump = -0.5 if interior else 0.5
    forms = []
    if slp:
        forms.append(sk.stokes_slp_self(curve))
    if dlp:
        forms.append(sk.stokes_dlp_self(curve) + jump * np.eye(2 * curve.N))
    A = (sk.stokes_slp_naive(source, curve.x, curve.y)
         + sk.stokes_pressure_fix(source, curve.normal_x, curve.normal_y))
    return QFSEvaluator(source, curve, forms, A, rcond,
                        build_u2s=build_u2s, device=device)


class _StokesHelper:
    """Per-boundary machinery of a one-boundary (interior) StokesSolver:
    annular solver, QFS maps, estimator rows, radial derivative
    operators."""

    def __init__(self, solver, ebdy: EmbeddedBoundary):
        self.ebdy = ebdy
        self.interior = ebdy.interior
        dev = solver.device
        geom = AnnularGeometry(ebdy.bdy.N, ebdy.M, ebdy.lb, ebdy.ub,
                               ebdy.approximate_radius)
        self.annular_solver = AnnularStokesSolver(geom, mu=1.0, device=dev)
        self.metric = AnnularMetric(ebdy.bdy.speed, ebdy.bdy.curvature, geom)
        ifc = ebdy.interface
        self.grid_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=self.interior)
        self.radial_source = ebdy.qfs_source_for_side(
            "interface", interior_eval=not self.interior)
        # the values->source maps and the own-source matrix serve only the
        # multi-boundary correction, which is not ported
        self.qfs_g = stokes_qfs(ifc, self.grid_source, self.interior,
                                build_u2s=False, device=dev)
        self.qfs_r = stokes_qfs(ifc, self.radial_source, not self.interior,
                                build_u2s=False, device=dev)
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                        device=dev)
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
        self.iterations_last_call = 0

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
        sigma_g = self.qfs_g([taus, taud])
        sigma_r = self.qfs_r([taus, taud])
        return (ur, vr, pr), sigma_g, sigma_r

    def solve_and_densities(self, fur, fvr, bu, bv, btxx, btxy, btyy,
                            tol, maxiter, restart):
        fr, ft = self.uv_to_rt(fur, fvr)
        z = self.zero_bc
        uvp_rt, stats = self.annular_solver.solve_with_stats(
            self.metric, fr, ft, z, z, z, z, tol=tol, maxiter=maxiter,
            restart=restart)
        self.iterations_last_call = self.annular_solver.iterations_last_call
        uvp, sigma_g, sigma_r = self.densities(uvp_rt, bu, bv, btxx, btxy,
                                               btyy)
        return uvp, sigma_g, sigma_r, stats

    def correct(self, uvp, sigma_r):
        """Add the radial-side field of sigma_r on the radial grid (the
        single-boundary shortcut of ipde_tpu's ``correct``: no other
        boundary's field to fold in)."""
        ur, vr, pr = uvp
        sN = self.radial_source.N
        du, dv, dp = self.radial_plan.apply(
            lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                sx, sy, sigma_r[:sN][::f] * ws, sigma_r[sN:][::f] * ws,
                tx, ty),
            n_out=3)
        return ur + du, vr + dv, pr + dp


class StokesSolver:
    """(u, v, p) = solver(fu, fv) with fu, fv EmbeddedFunctions; tensors on
    the collection's device.

    grid_backend: only 'dense' (the direct Stokeslet sum onto every
    physical-not-in-annulus grid point) is ported; 'fft' raises.
    solver_type: only 'spectral' is ported; 'fourth' raises.  The
    collection must hold one interior boundary.
    """

    def __init__(self, ebdyc: EmbeddedBoundaryCollection,
                 grid_backend: str = "dense", solver_type: str = "spectral"):
        self.ebdyc = ebdyc
        if ebdyc.grid is None:
            raise ValueError("collection has no registered grid")
        if grid_backend == "fft":
            raise NotImplementedError(
                "grid_backend='fft' (StokesFreespaceGridEvaluator) is not "
                "ported to ipde_tpu_torch yet: ROADMAP.md Queue 1 item 10")
        if grid_backend != "dense":
            raise ValueError(grid_backend)
        if solver_type == "fourth":
            raise NotImplementedError(
                "solver_type='fourth' is not ported to ipde_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 16)")
        if solver_type != "spectral":
            raise ValueError(solver_type)
        if len(ebdyc.ebdys) != 1 or not ebdyc.ebdys[0].interior:
            raise NotImplementedError(
                "StokesSolver of ipde_tpu_torch takes one interior boundary; "
                "multi-body and exterior Stokes are not ported yet "
                "(ROADMAP.md Queue 1 item 15)")
        if ebdyc.bumpy is None:
            ebdyc.ready_bump()
        self.device = ebdyc.device
        self.grid_backend = grid_backend
        self.solver_type = solver_type
        self.helpers = [_StokesHelper(self, e) for e in ebdyc]
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
        self._dense_tx = torch.cat([ebdyc.pna_x_dev,
                                    ebdyc.all_interface_x_dev])
        self._dense_ty = torch.cat([ebdyc.pna_y_dev,
                                    ebdyc.all_interface_y_dev])
        self.iteration_counts = []

    def __call__(self, fu: EmbeddedFunction, fv: EmbeddedFunction,
                 tol: float = 1e-12, maxiter: int = 200, restart: int = 50,
                 verbose: bool = False):
        (u, v, p), _ = self.solve_with_stats(fu, fv, tol=tol, maxiter=maxiter,
                                             restart=restart, verbose=verbose)
        return u, v, p

    def solve_with_stats(self, fu: EmbeddedFunction, fv: EmbeddedFunction,
                         tol: float = 1e-12, maxiter: int = 200,
                         restart: int = 50, verbose: bool = False):
        """Full Stokes solve, also returning {'annular_iterations': [ints],
        'annular_residuals': [floats]}.  The annular solve raises when GMRES
        ends with its true residual above tol."""
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
        # values + gradients of (u, v, p) at the interface in one pass
        vals, gxs, gys = ebdyc.interface_values_and_grads(stack3)
        bps = vals[2]
        btxxs = 2 * gxs[0] - bps
        btxys = gys[0] + gxs[1]
        btyys = 2 * gys[1] - bps
        v2l = ebdyc.v2l
        per = zip(self.helpers, fu.radials, fv.radials, v2l(vals[0]),
                  v2l(vals[1]), v2l(btxxs), v2l(btxys), v2l(btyys))
        uvps, sig_gs, sig_rs, stats_list = [], [], [], []
        for h, fur, fvr, bu, bv, txx, txy, tyy in per:
            uvp, sg, sr, st = h.solve_and_densities(fur, fvr, bu, bv, txx,
                                                    txy, tyy, tol, maxiter,
                                                    restart)
            uvps.append(uvp)
            sig_gs.append(sg)
            sig_rs.append(sr)
            stats_list.append(st)
        stats = {"annular_iterations": [s["iterations"] for s in stats_list],
                 "annular_residuals": [s["residual"] for s in stats_list]}
        self.iteration_counts = list(stats["annular_iterations"])
        if verbose:
            print("annular Stokes iterations:", self.iteration_counts)
        # merged sigma_g evaluation onto pna + interfaces
        wfx = torch.cat([s[:n] for s, n in zip(sig_gs, self.src_Ns)])
        wfy = torch.cat([s[n:] for s, n in zip(sig_gs, self.src_Ns)])
        gu, gv, gp = sk.stokes_slp_apply(
            self.grid_src_x, self.grid_src_y, wfx * self.grid_src_w,
            wfy * self.grid_src_w, self._dense_tx, self._dense_ty)
        n_pna = ebdyc.pna_x.size
        idx = ebdyc.pna_flat_dev
        uc, vc, pc = (c.reshape(-1).index_add(0, idx, g[:n_pna])
                      .reshape(c.shape) for c, g in ((uc, gu), (vc, gv),
                                                     (pc, gp)))
        # grid-side pressure at the interfaces (FFT solution + sigma_g field)
        bpl = v2l(bps + gp[n_pna:])
        out = [h.correct(uvp, sr)
               for h, uvp, sr in zip(self.helpers, uvps, sig_rs)]
        urs = [o[0] for o in out]
        vrs = [o[1] for o in out]
        # Stokes pressure is only defined up to a constant per region: the
        # annular and grid solves each pin their own; reconcile by matching
        # the mean pressure across the interface (as ipde_tpu does; the
        # reference leaves the mismatch, internals/vector.py:134-141)
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
