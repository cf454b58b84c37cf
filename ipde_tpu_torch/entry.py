"""Entry point of the port: the counterpart of
``__graft_entry__.entry()``.

``entry()`` returns ``(fn, args)``: ``fn(*args)`` runs one full interior
Poisson solve (box FFT solve, annular GMRES, QFS coupling, layer potentials
through the CUDA kernels) plus the Dirichlet BIE correction at nb=128, M=8
on the card, and returns the corrected solution on the grid.  ipde_tpu's
``planify`` (plan arrays as jit arguments) has no counterpart: the port
runs eagerly.  ``dryrun_multichip`` waits for the multi-GPU layer
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import numpy as np


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


def build_problem(nb: int = 128, M: int = 8, device=None):
    """__graft_entry__._build_problem's one-boundary Poisson problem on
    ``device`` (None: the card): (solver, bie, f, bc)."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import DirichletBIE
    from ipde_tpu_torch.solvers.scalar import PoissonSolver

    bdy = star(nb, a=0.1, f=3)
    # keep the annulus comfortably inside the curvature radius
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
        device=device)
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    return solver, DirichletBIE(solver), f, bc


def entry(device=None):
    """(fn, args): ``fn(f_grid, f_radial)`` is one full Poisson solve +
    apply_bc (GMRES tol 1e-12, maxiter 60, restart 30) returning the grid
    solution; ``args`` are the problem's forcing on ``device`` (None: the
    card; raises without one)."""
    from ipde_tpu_torch.functions import EmbeddedFunction

    solver, bie, f, bc = build_problem(device=device)

    def step(f_grid, f_radial):
        ue = solver(EmbeddedFunction(f_grid, [f_radial]), tol=1e-12,
                    maxiter=60, restart=30)
        return bie.apply_bc(ue, bc).grid

    step.solver = solver
    return step, (f.grid, f.radials[0])
