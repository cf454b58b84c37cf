"""Boundary integral equations for the physical boundary conditions.

After the inhomogeneous solve, the PDE residual is a homogeneous solution
determined by a dense BIE on the true boundaries (reference: done in the
example drivers, e.g. examples/interior_poisson.py:84-92).  The BIE matrix is
assembled and inverted at setup, on the host (LAPACK) or on the device
(forms from ops/forms_dev.py, torch.linalg.inv, one refinement pass per
solve), as ``_bie_backend`` picks; the solve-time path is matmuls,
the field on the grid (the solver's FFT evaluator over the BIE's own QFS
sources with ``grid_backend="fft"``, the CUDA kernel at every physical point
with ``"dense"``) and dense layer evaluations onto the radial grids in the
CUDA kernel.  The scalar BIEs follow their solver's ``use_mesh``: their
kernel applies then run target-sharded, as in ipde_tpu;
``StokesDirichletBIE`` stays on one device, as ipde_tpu's does.

Dirichlet representation: u_H = sum_j DLP_j[tau_j], collocated on every
boundary with the one-sided limit taken from the physical side; for Stokes
the DLP is the stresslet, with the normal-flux rank completion.  Neumann
representation: u_H = sum_j SLP_j[sigma_j], collocating the normal
derivative from the physical side.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.ops import forms_dev as fd
from ipde_tpu_torch.ops import kernels
from ipde_tpu_torch.ops import singular as sq
from ipde_tpu_torch.ops import stokes_kernels as sk
from ipde_tpu_torch.ops.stratified import StratifiedRadialApply
from ipde_tpu_torch.qfs.qfs import auto_backend
from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver, ScalarSolver
from ipde_tpu_torch.solvers.vector import StokesSolver, stokes_qfs
from ipde_tpu_torch.utils.profiling import spanned


def _radial_plans(src_list, ebdyc, dev):
    """The stratified radial plans [target ebdy i][source boundary j] of the
    BIE's effective sources.  Only an interior boundary's own plan
    subsamples its sources.  The plan's bound takes the density's modes
    above the boundary's band limit (N / 2) as negligible, but a BIE density
    on the 3 N-point QFS source curve carries them at up to 2.5e-6 of its
    largest mode (the three-body Stokes problem of
    examples/stokes_refinement.py at nb=700).  The interior boundary's own
    rows tolerate that; another boundary's rows and an inclusion's do not:
    ipde_tpu subsamples them all and reaches a velocity error of 7.1e-6 on
    that problem at M=16 (CPU), 6.3e-9 with every source taken
    (tools/ipde_tpu_three_body_stokes.py)."""
    return [[StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                   k_density=ej.bdy.N // 2,
                                   max_stride=16 if e is ej and e.interior
                                   else 1, device=dev)
             for src, ej in zip(src_list, ebdyc)]
            for e in ebdyc]


def _device_mirrors(src_list, dev):
    """The source curves' x, y and weights on ``dev``, held by the BIE:
    made with it, so that ``utils/planify.py``'s plan store finds them, and
    not cached on the curves, which the collection shares with the next
    step's objects."""
    return [{name: torch.as_tensor(getattr(src, name), dtype=torch.float64,
                                   device=dev).contiguous()
             for name in ("x", "y", "weights")} for src in src_list]


def _bie_backend(n: int, device) -> str:
    """The BIE build backend: ``IPDE_BIE_BACKEND=host|device`` overrides,
    else ``qfs.auto_backend(n, device)`` (n: the smallest boundary)."""
    env = os.environ.get("IPDE_BIE_BACKEND")
    if env:
        if env not in ("host", "device"):
            raise ValueError(f"IPDE_BIE_BACKEND={env!r}: host or device")
        return env
    return auto_backend(n, device)


@spanned("setup.bie.invert")
def _invert_system(blocks, offs, backend: str, device):
    """Assemble the block BIE matrix and invert it: (A_dev, Ainv) on
    ``device``.  backend "device": the blocks are tensors on ``device``,
    assembled there and inverted by torch.linalg.inv (LU with partial
    pivoting; cuSOLVER on a card); A_dev is kept for ``_solve_bie``'s
    refinement pass.  backend "host": numpy blocks, a LAPACK inverse
    uploaded, A_dev None."""
    if backend == "device":
        A = torch.cat([torch.cat(list(row), dim=1) for row in blocks], dim=0)
        return A, torch.linalg.inv(A)
    n = offs[-1]
    A = np.zeros((n, n))
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            A[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = np.asarray(b)
    return None, torch.as_tensor(np.linalg.inv(A), device=device)


def _solve_bie(A_dev, Ainv, rhs):
    """A^{-1} rhs, with ipde_tpu's one refinement pass wherever A_dev is
    kept (the device backend)."""
    tau = Ainv @ rhs
    if A_dev is not None:
        tau = tau + Ainv @ (rhs - A_dev @ tau)
    return tau


class _ScalarBIE:
    """What the scalar BIEs share: their targets (every physical grid point
    and the radial grids) and the evaluation of their effective densities
    there through the solver's kernel."""

    def _make_targets(self, ebdyc, dev):
        """The radial plans of ``self.src_list`` (``_radial_plans``), and
        the grid targets: the FFT evaluator over
        all of ``self.src_list`` (grid_backend "fft"), or the physical grid
        points (pna + in-annulus) for the kernel ("dense")."""
        self.radial_plans = _radial_plans(self.src_list, ebdyc, dev)
        self.src_dev = _device_mirrors(self.src_list, dev)
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
                sig * d["weights"] for d, sig in zip(self.src_dev, sigmas)]))
            new_grid = ue.grid + torch.where(self.ebdyc.phys_dev, phi, 0.0)
        else:
            grid_vals = torch.zeros_like(self.phys_x)
            for d, sig in zip(self.src_dev, sigmas):
                grid_vals = grid_vals + solver._apply(d, sig, self.phys_x,
                                                      self.phys_y)
            new_grid = ue.grid.reshape(-1).index_add(0, self.phys_flat,
                                                     grid_vals)\
                .reshape(ue.grid.shape)
        # the radial fields: through the stratified plans, or under the
        # solver's mesh (read here, so a BIE built before use_mesh follows
        # it) every source at once onto each ravelled radial grid (the
        # helpers' radial_tx, radial_ty), sharded
        new_radials = list(ue.radials)
        for j, (d, sig) in enumerate(zip(self.src_dev, sigmas)):
            for i, (r, h) in enumerate(zip(new_radials, solver.helpers)):
                if solver._mesh is None:
                    v = self.radial_plans[i][j].apply(
                        lambda sx, sy, ws, f, tx, ty: solver._apply_raw(
                            sx, sy, sig[::f] * ws, tx, ty))
                else:
                    v = solver._apply(d, sig, h.radial_tx, h.radial_ty)\
                        .reshape(r.shape)
                new_radials[i] = r + v
        return EmbeddedFunction(new_grid, new_radials)


class DirichletBIE(_ScalarBIE):
    """Dense Dirichlet BIE for a ScalarSolver's boundary collection; its
    tensors live on the collection's device."""

    @spanned("setup.bie")
    def __init__(self, solver: ScalarSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        dev = ebdyc.device
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum(Ns)])
        backend = _bie_backend(min(Ns), dev)
        builders = fd.FormBuilders(backend, dev)
        blocks = [[self._dlp_block(ei, ej, builders) for ej in ebdyc]
                  for ei in ebdyc]
        self.A_dev, self.Ainv = _invert_system(blocks, offs, backend, dev)
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

    def _dlp_block(self, ei, ej, b: fd.FormBuilders):
        """Representation: interior boundary -> DLP[tau]; inclusion
        (exterior) boundary -> (DLP + SLP)[tau].  The Laplace exterior DLP
        alone is rank-deficient (DLP of a constant density vanishes outside
        a closed curve); adding the SLP of the SAME density restores full
        rank consistently -- the evaluation uses the identical combination.
        The Yukawa DLP is complete for inclusions: no SLP added there.

        ``b``: the backend's form builders; the Yukawa self block is
        host-built on either backend (uploaded for "device", as in
        ipde_tpu)."""
        solver = self.solver
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        bi, bj = ei.bdy, ej.bdy
        if ei is ej:
            if is_mh:
                D = b.lift(sq.mh_dlp_self(bj, solver.k))
            else:
                D = b.form("laplace_dlp_self")(bj)
                if not ej.interior:
                    D = D + b.form("laplace_slp_self")(bj)
            jump = -0.5 if ej.interior else 0.5
            return D + jump * b.eye(bj.N)
        if is_mh:
            return b.form("mh_dlp_naive")(bj, bi.x, bi.y, solver.k)
        D = b.form("laplace_dlp_naive")(bj, bi.x, bi.y)
        if not ej.interior:
            D = D + b.form("laplace_slp_naive")(bj, bi.x, bi.y)
        return D

    def apply_bc(self, ue: EmbeddedFunction,
                 bc: BoundaryFunction) -> EmbeddedFunction:
        """Correct ue so that it satisfies u = bc on every boundary."""
        solver = self.solver
        bvs = solver.get_boundary_values(ue)
        rhs = torch.cat([b - v for b, v in zip(bc.values, bvs.values)])
        tau = _solve_bie(self.A_dev, self.Ainv, rhs)
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

    @spanned("setup.bie")
    def __init__(self, solver: ScalarSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        dev = ebdyc.device
        is_mh = isinstance(solver, ModifiedHelmholtzSolver)
        Ns = [e.bdy.N for e in ebdyc]
        offs = np.concatenate([[0], np.cumsum(Ns)])
        backend = _bie_backend(min(Ns), dev)
        b = fd.FormBuilders(backend, dev)

        def blk(ei, ej):
            bi, bj = ei.bdy, ej.bdy
            if ei is ej:
                own = (b.lift(sq.mh_slp_normal_self(bj, solver.k)) if is_mh
                       else b.form("laplace_slp_normal_self")(bj))
                jump = 0.5 if ej.interior else -0.5
                return own + jump * b.eye(bj.N)
            if is_mh:
                return b.form("mh_slp_normal_naive")(
                    bj, bi.x, bi.y, bi.normal_x, bi.normal_y, solver.k)
            return b.form("laplace_slp_normal_naive")(
                bj, bi.x, bi.y, bi.normal_x, bi.normal_y)

        blocks = [[blk(ei, ej) for ej in ebdyc] for ei in ebdyc]
        if not is_mh and len(ebdyc.ebdys) == 1 and ebdyc.ebdys[0].interior:
            # pin the Laplace Neumann nullspace: add mean(sigma) to all rows
            blocks[0][0] = blocks[0][0] + b.lift(
                ebdyc.ebdys[0].bdy.weights[None, :])
        self.A_dev, self.Ainv = _invert_system(blocks, offs, backend, dev)
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
        sig = _solve_bie(self.A_dev, self.Ainv, rhs)
        xis = [q([sig[self.offs[i]:self.offs[i + 1]]])
               for i, q in enumerate(self.qfs_list)]
        return self._add_fields(ue, xis)


def solve_dirichlet(solver: ScalarSolver, f: EmbeddedFunction,
                    bc: BoundaryFunction, bie: DirichletBIE = None,
                    **kw) -> EmbeddedFunction:
    """Convenience: full inhomogeneous solve + Dirichlet BC in one call
    (``kw`` go to the solver: tol, maxiter, restart, verbose).  The port's
    GMRES checks its TRUE residual against tol and raises above it; its
    float64 floor is about 3e-14, so the reference's tol=1e-14 raises
    instead of returning a solution: pass tol >= 1e-13 (the solver's default
    is 1e-12)."""
    if bie is None:
        bie = DirichletBIE(solver)
    ue = solver(f, **kw)
    return bie.apply_bc(ue, bc)


class StokesDirichletBIE:
    """Dense velocity-Dirichlet BIE for a StokesSolver's boundary
    collection (one interior boundary and any number of inclusions); its
    tensors live on the collection's device.

    Representation (reference: examples/multi_stokes_for_paper.py:117-190):
    the interior boundary carries DLP[tau] with the normal-flux rank
    completion, an inclusion (SLP + DLP)[tau] of one density; the one-sided
    limits are taken from the physical side.  The blocks are built and
    inverted on the host or the device, as ``_bie_backend`` picks (2N rows
    per boundary); the QFS forms are DLP-only
    for the interior boundary and [SLP, DLP] for an inclusion.
    """

    @spanned("setup.bie")
    def __init__(self, solver: StokesSolver):
        self.solver = solver
        ebdyc = solver.ebdyc
        self.ebdyc = ebdyc
        dev = ebdyc.device
        backend = _bie_backend(min(e.bdy.N for e in ebdyc), dev)
        b = fd.FormBuilders(backend, dev)
        dlp_self, slp_self, fix, dlp, slp = (b.form(name) for name in (
            "stokes_dlp_self", "stokes_slp_self", "stokes_pressure_fix",
            "stokes_dlp_naive", "stokes_slp_naive"))

        def blk(ei, ej):
            bi, bj = ei.bdy, ej.bdy
            if ei is ej:
                if ej.interior:
                    return (dlp_self(bj) - 0.5 * b.eye(2 * bj.N)
                            + fix(bj, bj.normal_x, bj.normal_y))
                return dlp_self(bj) + slp_self(bj) + 0.5 * b.eye(2 * bj.N)
            if ej.interior:
                return (dlp(bj, bi.x, bi.y)
                        + fix(bj, bi.normal_x, bi.normal_y))
            return dlp(bj, bi.x, bi.y) + slp(bj, bi.x, bi.y)

        offs = np.concatenate([[0], np.cumsum([2 * e.bdy.N
                                               for e in ebdyc])])
        blocks = [[blk(ei, ej) for ej in ebdyc] for ei in ebdyc]
        self.A_dev, self.Ainv = _invert_system(blocks, offs, backend, dev)
        self.offs = offs
        # per-boundary QFS, matched from the physical side
        self.src_list = [e.qfs_source_for_side("bdy", interior_eval=e.interior)
                         for e in ebdyc]
        self.qfs_list = [stokes_qfs(e.bdy, src, e.interior,
                                    slp=not e.interior, dlp=True,
                                    build_u2s=False, device=dev)
                         for e, src in zip(ebdyc, self.src_list)]
        self.radial_plans = _radial_plans(self.src_list, ebdyc, dev)
        self.src_dev = _device_mirrors(self.src_list, dev)
        self.grid_eval = None
        if solver.grid_backend == "fft":
            self.grid_eval = solver._make_grid_evaluator(
                np.concatenate([s.x for s in self.src_list]),
                np.concatenate([s.y for s in self.src_list]))
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
        ebdyc = self.ebdyc
        bu = solver.get_boundary_values(u)
        bv = solver.get_boundary_values(v)
        rhs = torch.cat([torch.cat([cu - gu, cv - gv]) for cu, cv, gu, gv in
                         zip(bc_u.values, bc_v.values, bu.values, bv.values)])
        tau = _solve_bie(self.A_dev, self.Ainv, rhs)
        sigmas = []
        for i, (e, q) in enumerate(zip(ebdyc, self.qfs_list)):
            t = tau[self.offs[i]:self.offs[i + 1]]
            sigmas.append(q([t]) if e.interior else q([t, t]))
        # weighted force components per source curve
        forces = []
        for src, d, sig in zip(self.src_list, self.src_dev, sigmas):
            w = d["weights"]
            forces.append((sig[:src.N] * w, sig[src.N:] * w))
        # onto all physical grid points and every radial grid
        if self.grid_eval is not None:
            phys = ebdyc.phys_dev
            fields = self.grid_eval(torch.cat([f[0] for f in forces]),
                                    torch.cat([f[1] for f in forces]))
            grids = [f.grid + torch.where(phys, g, 0.0)
                     for f, g in zip((u, v, p), fields)]
        else:
            vals = [torch.zeros_like(self.phys_x) for _ in range(3)]
            for d, (wfx, wfy) in zip(self.src_dev, forces):
                vals = [a + b for a, b in zip(vals, sk.stokes_slp_apply(
                    d["x"], d["y"], wfx, wfy, self.phys_x, self.phys_y))]
            grids = [f.grid.reshape(-1).index_add(0, self.phys_flat, g)
                     .reshape(f.grid.shape)
                     for f, g in zip((u, v, p), vals)]
        radials = [list(f.radials) for f in (u, v, p)]
        for j, (src, sig) in enumerate(zip(self.src_list, sigmas)):
            sN = src.N
            for i in range(len(ebdyc.ebdys)):
                upd = self.radial_plans[i][j].apply(
                    lambda sx, sy, ws, f, tx, ty: sk.stokes_slp_apply(
                        sx, sy, sig[:sN][::f] * ws, sig[sN:][::f] * ws, tx,
                        ty),
                    n_out=3)
                for r, du in zip(radials, upd):
                    r[i] = r[i] + du
        return tuple(EmbeddedFunction(g, r) for g, r in zip(grids, radials))
