"""Boundary integral equations for the physical boundary conditions.

After the inhomogeneous solve, the PDE residual is a homogeneous solution
determined by a dense BIE on the true boundaries (reference: done in the
example drivers, e.g. examples/interior_poisson.py:84-92).  The BIE matrix is
assembled and inverted on the host at setup; the solve-time path is matmuls,
the field on the grid (the solver's FFT evaluator over the BIE's own QFS
sources with ``grid_backend="fft"``, the CUDA kernel at every physical point
with ``"dense"``) and dense layer evaluations onto the radial grids in the
CUDA kernel.

Dirichlet representation: u_H = sum_j DLP_j[tau_j], collocated on every
boundary with the one-sided limit taken from the physical side; for Stokes
the DLP is the stresslet, with the normal-flux rank completion.  Neumann
representation: u_H = sum_j SLP_j[sigma_j], collocating the normal
derivative from the physical side.
"""

from __future__ import annotations

import numpy as np
import torch

from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.ops import kernels
from ipde_tpu_torch.ops import singular as sq
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver, ScalarSolver
from ipde_tpu_torch.solvers.vector import StokesSolver, stokes_qfs


def _invert_system(blocks, offs) -> np.ndarray:
    """Assemble the block BIE matrix on the host and invert it (LAPACK)."""
    n = offs[-1]
    A = np.zeros((n, n))
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            A[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = np.asarray(b)
    return np.linalg.inv(A)


class _ScalarBIE:
    """What the scalar BIEs share: their targets (every physical grid point
    and the radial grids) and the evaluation of their effective densities
    there through the solver's kernel."""

    def _make_targets(self, ebdyc, dev):
        """The stratified radial plans [target ebdy i][source boundary j]
        of ``self.src_list``, and the grid targets: the FFT evaluator over
        all of ``self.src_list`` (grid_backend "fft"), or the physical grid
        points (pna + in-annulus) for the kernel ("dense")."""
        self.radial_plans = [
            [StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                   k_density=ej.bdy.N // 2, device=dev)
             for src, ej in zip(self.src_list, ebdyc)]
            for e in ebdyc]
        self.grid_eval = None
        if self.solver.grid_backend == "fft":
            self.grid_eval = self.solver._make_grid_evaluator(
                np.concatenate([s.x for s in self.src_list]),
                np.concatenate([s.y for s in self.src_list]))
            return
        phys = ebdyc.phys
        phys_x = torch.as_tensor(ebdyc.grid.xg[phys], device=dev)
        phys_y = torch.as_tensor(ebdyc.grid.yg[phys], device=dev)
        # in spatial order (compact warps for the Yukawa kernel), with the
        # flat indices their values are scattered to in the same order
        order = kernels.spatial_order(phys_x, phys_y,
                                      cell=min(ebdyc.grid.xh, ebdyc.grid.yh))
        self.phys_flat = torch.as_tensor(np.flatnonzero(phys),
                                         device=dev)[order]
        self.phys_x = phys_x[order]
        self.phys_y = phys_y[order]

    def _add_fields(self, ue: EmbeddedFunction, sigmas) -> EmbeddedFunction:
        """ue plus the field of each effective density ``sigmas[j]`` on
        ``self.src_list[j]`` at all physical grid points and every radial
        grid."""
        solver = self.solver
        if self.grid_eval is not None:
            phi = self.grid_eval(torch.cat([
                sig * src.dev(sig.device)["weights"]
                for src, sig in zip(self.src_list, sigmas)]))
            new_grid = ue.grid + torch.where(self.ebdyc.phys_dev, phi, 0.0)
        else:
            grid_vals = torch.zeros_like(self.phys_x)
            for src, sig in zip(self.src_list, sigmas):
                grid_vals = grid_vals + solver._apply(src, sig, self.phys_x,
                                                      self.phys_y)
            new_grid = ue.grid.reshape(-1).index_add(0, self.phys_flat,
                                                     grid_vals)\
                .reshape(ue.grid.shape)
        new_radials = list(ue.radials)
        for j, sig in enumerate(sigmas):
            for i in range(len(new_radials)):
                new_radials[i] = new_radials[i] + self.radial_plans[i][j].apply(
                    lambda sx, sy, ws, f, tx, ty: solver._apply_raw(
                        sx, sy, sig[::f] * ws, tx, ty))
        return EmbeddedFunction(new_grid, new_radials)


class DirichletBIE(_ScalarBIE):
    """Dense Dirichlet BIE for a ScalarSolver's boundary collection; its
    tensors live on the collection's device."""

    def __init__(self, solver: ScalarSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        dev = ebdyc.device
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum(Ns)])
        blocks = [[self._dlp_block(ei, ej) for ej in ebdyc] for ei in ebdyc]
        self.Ainv = torch.as_tensor(_invert_system(blocks, offs), device=dev)
        self.offs = offs
        # per-boundary QFS of the DLP, matched from the physical side,
        # effective sources on the far side of the physical region
        self.qfs_list = []
        self.src_list = []
        for e in ebdyc:
            src = e.qfs_source_for_side("bdy", interior_eval=e.interior,
                                        alpha=solver._qfs_alpha(e))
            self.src_list.append(src)
            self.qfs_list.append(
                solver._make_qfs(e.bdy, src, e.interior, build_u2s=False))
        self._make_targets(ebdyc, dev)

    def _dlp_block(self, ei, ej):
        """Representation: interior boundary -> DLP[tau]; inclusion
        (exterior) boundary -> (DLP + SLP)[tau].  The Laplace exterior DLP
        alone is rank-deficient (DLP of a constant density vanishes outside
        a closed curve); adding the SLP of the SAME density restores full
        rank consistently -- the evaluation uses the identical combination.
        The Yukawa DLP is complete for inclusions: no SLP added there."""
        solver = self.solver
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        if ei is ej:
            if is_mh:
                D = sq.mh_dlp_self(ej.bdy, solver.k)
            else:
                D = sq.laplace_dlp_self(ej.bdy)
                if not ej.interior:
                    D = D + sq.laplace_slp_self(ej.bdy)
            jump = -0.5 if ej.interior else 0.5
            return D + jump * np.eye(ej.bdy.N)
        if is_mh:
            return sq.mh_dlp_naive(ej.bdy, ei.bdy.x, ei.bdy.y, solver.k)
        D = sq.laplace_dlp_naive(ej.bdy, ei.bdy.x, ei.bdy.y)
        if not ej.interior:
            D = D + sq.laplace_slp_naive(ej.bdy, ei.bdy.x, ei.bdy.y)
        return D

    def apply_bc(self, ue: EmbeddedFunction,
                 bc: BoundaryFunction) -> EmbeddedFunction:
        """Correct ue so that it satisfies u = bc on every boundary."""
        solver = self.solver
        bvs = solver.get_boundary_values(ue)
        rhs = torch.cat([b - v for b, v in zip(bc.values, bvs.values)])
        tau = self.Ainv @ rhs
        taus = [tau[self.offs[i]:self.offs[i + 1]]
                for i in range(len(self.ebdyc.ebdys))]
        # effective sources; QFS forms are [slp, dlp].  Laplace inclusions
        # use (SLP + DLP) of the same density (see _dlp_block); everything
        # else is DLP-only.
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        sigmas = [q([t if not (e.interior or is_mh) else torch.zeros_like(t),
                     t])
                  for q, t, e in zip(self.qfs_list, taus, self.ebdyc)]
        return self._add_fields(ue, sigmas)


class NeumannBIE(_ScalarBIE):
    """Dense Neumann BIE for a ScalarSolver's boundary collection: u_H =
    sum_j SLP_j[sigma_j], collocating the normal derivative from the
    physical side (reference:
    examples/interior_modified_helmholtz_using_multi_neumann_bc.py); its
    tensors live on the collection's device.

    For the modified Helmholtz kernel the system is well posed; for Laplace
    an interior pure-Neumann problem carries the usual compatibility
    condition and the constant nullspace is pinned with a mean constraint.
    """

    def __init__(self, solver: ScalarSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        dev = ebdyc.device
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum(Ns)])

        def blk(ei, ej):
            bi, bj = ei.bdy, ej.bdy
            if ei is ej:
                b = (sq.mh_slp_normal_self(bj, solver.k) if is_mh
                     else sq.laplace_slp_normal_self(bj))
                jump = 0.5 if ej.interior else -0.5
                return b + jump * np.eye(bj.N)
            if is_mh:
                return sq.mh_slp_normal_naive(bj, bi.x, bi.y, bi.normal_x,
                                              bi.normal_y, solver.k)
            return sq.laplace_slp_normal_naive(bj, bi.x, bi.y, bi.normal_x,
                                               bi.normal_y)

        blocks = [[blk(ei, ej) for ej in ebdyc] for ei in ebdyc]
        if not is_mh and len(ebdyc.ebdys) == 1 and ebdyc.ebdys[0].interior:
            # pin the Laplace Neumann nullspace: add mean(sigma) to all rows
            blocks[0][0] = blocks[0][0] + ebdyc.ebdys[0].bdy.weights[None, :]
        self.Ainv = torch.as_tensor(_invert_system(blocks, offs), device=dev)
        self.offs = offs
        self.qfs_list = []
        self.src_list = []
        for e in ebdyc:
            src = e.qfs_source_for_side("bdy", interior_eval=e.interior,
                                        alpha=solver._qfs_alpha(e))
            self.src_list.append(src)
            self.qfs_list.append(
                solver._make_qfs_slp_only(e.bdy, src, e.interior))
        self._make_targets(ebdyc, dev)

    def apply_bc(self, ue: EmbeddedFunction,
                 bc_n: BoundaryFunction) -> EmbeddedFunction:
        """Correct ue so that du/dn = bc_n on every boundary."""
        bns = self.solver.get_boundary_normal_derivatives(ue)
        rhs = torch.cat([b - v for b, v in zip(bc_n.values, bns.values)])
        sig = self.Ainv @ rhs
        xis = [q([sig[self.offs[i]:self.offs[i + 1]]])
               for i, q in enumerate(self.qfs_list)]
        return self._add_fields(ue, xis)


class StokesDirichletBIE:
    """Dense velocity-Dirichlet BIE for a one-boundary StokesSolver; its
    tensors live on the collection's device.

    Representation (reference: examples/multi_stokes_for_paper.py:117-190):
    the (interior) boundary carries DLP[tau] with the normal-flux rank
    completion; the one-sided limit is taken from the physical side.  The
    block is built and inverted on the host; the QFS forms are DLP-only.
    """

    def __init__(self, solver: StokesSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        dev = ebdyc.device
        (e,) = ebdyc.ebdys    # StokesSolver takes one interior boundary
        b = e.bdy
        A = (sk.stokes_dlp_self(b) - 0.5 * np.eye(2 * b.N)
             + sk.stokes_pressure_fix(b, b.normal_x, b.normal_y))
        self.Ainv = torch.as_tensor(_invert_system([[A]], [0, 2 * b.N]),
                                    device=dev)
        self.src = e.qfs_source_for_side("bdy", interior_eval=True)
        self.qfs = stokes_qfs(b, self.src, True, slp=False, dlp=True,
                              build_u2s=False, device=dev)
        self.radial_plan = StratifiedRadialApply(
            self.src, e.radial_x, e.radial_y, k_density=b.N // 2, device=dev)
        self.grid_eval = None
        if solver.grid_backend == "fft":
            self.grid_eval = solver._make_grid_evaluator(self.src.x,
                                                         self.src.y)
        else:
            # all physical grid points (pna + in-annulus)
            phys = ebdyc.phys
            self.phys_flat = torch.as_tensor(np.flatnonzero(phys),
                                             device=dev)
            self.phys_x = torch.as_tensor(ebdyc.grid.xg[phys], device=dev)
            self.phys_y = torch.as_tensor(ebdyc.grid.yg[phys], device=dev)

    def apply_bc(self, u, v, p, bc_u, bc_v):
        """Correct (u, v, p) to satisfy the velocity boundary conditions."""
        solver = self.solver
        bu = solver.get_boundary_values(u)
        bv = solver.get_boundary_values(v)
        rhs = torch.cat([bc_u.values[0] - bu.values[0],
                         bc_v.values[0] - bv.values[0]])
        sig = self.qfs([self.Ainv @ rhs])
        d = self.src.dev(self.ebdyc.device)
        sN = self.src.N
        wfx, wfy = sig[:sN] * d["weights"], sig[sN:] * d["weights"]
        # evaluate onto all physical grid points and the radial grid
        if self.grid_eval is not None:
            phys = self.ebdyc.phys_dev
            grids = [f.grid + torch.where(phys, g, 0.0)
                     for f, g in zip((u, v, p), self.grid_eval(wfx, wfy))]
        else:
            grids = [f.grid.reshape(-1).index_add(0, self.phys_flat, g)
                     .reshape(f.grid.shape)
                     for f, g in zip((u, v, p), sk.stokes_slp_apply(
                         d["x"], d["y"], wfx, wfy, self.phys_x,
                         self.phys_y))]
        radials = self.radial_plan.apply(
            lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                sx, sy, sig[:sN][::f] * ws, sig[sN:][::f] * ws, tx, ty),
            n_out=3)
        return tuple(EmbeddedFunction(g, [f.radials[0] + r])
                     for f, g, r in zip((u, v, p), grids, radials))
