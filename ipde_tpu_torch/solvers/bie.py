"""Boundary integral equations for the physical Dirichlet boundary condition.

After the inhomogeneous solve, the PDE residual is a homogeneous solution
determined by a dense BIE on the true boundaries (reference: done in the
example drivers, e.g. examples/interior_poisson.py:84-92).  The BIE matrix is
assembled and inverted on the host at setup; the solve-time path is matmuls
plus dense layer evaluations in the CUDA kernel.

Dirichlet representation: u_H = sum_j DLP_j[tau_j], collocated on every
boundary with the one-sided limit taken from the physical side; for Stokes
the DLP is the stresslet, with the normal-flux rank completion.
"""

from __future__ import annotations

import numpy as np
import torch

from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.ops import singular as sq
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.solvers.scalar import ScalarSolver
from ipde_tpu_torch.solvers.vector import StokesSolver, stokes_qfs


def _invert_system(blocks, offs) -> np.ndarray:
    """Assemble the block BIE matrix on the host and invert it (LAPACK)."""
    n = offs[-1]
    A = np.zeros((n, n))
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            A[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = np.asarray(b)
    return np.linalg.inv(A)


class DirichletBIE:
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
            src = e.qfs_source_for_side("bdy", interior_eval=e.interior)
            self.src_list.append(src)
            self.qfs_list.append(
                solver._make_qfs(e.bdy, src, e.interior, build_u2s=False))
        # stratified subsampling plans [target ebdy i][source boundary j]
        self.radial_plans = [
            [StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                   k_density=ej.bdy.N // 2, device=dev)
             for src, ej in zip(self.src_list, ebdyc)]
            for e in ebdyc]
        # all physical grid points (pna + in-annulus)
        phys = ebdyc.phys
        self.phys_flat = torch.as_tensor(np.flatnonzero(phys), device=dev)
        self.phys_x = torch.as_tensor(ebdyc.grid.xg[phys], device=dev)
        self.phys_y = torch.as_tensor(ebdyc.grid.yg[phys], device=dev)

    def _dlp_block(self, ei, ej):
        """Representation: interior boundary -> DLP[tau]; inclusion
        (exterior) boundary -> (DLP + SLP)[tau].  The Laplace exterior DLP
        alone is rank-deficient (DLP of a constant density vanishes outside
        a closed curve); adding the SLP of the SAME density restores full
        rank consistently -- the evaluation uses the identical combination."""
        if ei is ej:
            D = sq.laplace_dlp_self(ej.bdy)
            if not ej.interior:
                D = D + sq.laplace_slp_self(ej.bdy)
            jump = -0.5 if ej.interior else 0.5
            return D + jump * np.eye(ej.bdy.N)
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
        # use (SLP + DLP) of the same density (see _dlp_block); interior
        # boundaries are DLP-only.
        sigmas = [q([t if not e.interior else torch.zeros_like(t), t])
                  for q, t, e in zip(self.qfs_list, taus, self.ebdyc)]
        # evaluate onto all physical grid points and every radial grid
        grid_vals = torch.zeros_like(self.phys_x)
        for src, sig in zip(self.src_list, sigmas):
            grid_vals = grid_vals + solver._apply(src, sig, self.phys_x,
                                                  self.phys_y)
        new_grid = ue.grid.reshape(-1).index_add(0, self.phys_flat, grid_vals)\
            .reshape(ue.grid.shape)
        new_radials = list(ue.radials)
        for j, sig in enumerate(sigmas):
            for i in range(len(self.ebdyc.ebdys)):
                new_radials[i] = new_radials[i] + self.radial_plans[i][j].apply(
                    lambda sx, sy, ws, f, tx, ty: solver._apply_raw(
                        sx, sy, sig[::f] * ws, tx, ty))
        return EmbeddedFunction(new_grid, new_radials)


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
        # all physical grid points (pna + in-annulus)
        phys = ebdyc.phys
        self.phys_flat = torch.as_tensor(np.flatnonzero(phys), device=dev)
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
        # evaluate onto all physical grid points and the radial grid
        gu, gv, gp = sk.stokes_slp_apply(
            d["x"], d["y"], sig[:sN] * d["weights"], sig[sN:] * d["weights"],
            self.phys_x, self.phys_y)
        ru, rv, rp = self.radial_plan.apply(
            lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                sx, sy, sig[:sN][::f] * ws, sig[sN:][::f] * ws, tx, ty),
            n_out=3)
        return tuple(
            EmbeddedFunction(
                f.grid.reshape(-1).index_add(0, self.phys_flat, g)
                .reshape(f.grid.shape), [f.radials[0] + r])
            for f, g, r in ((u, gu, ru), (v, gv, rv), (p, gp, rp)))
