"""Entry points of the port: the counterparts of
``__graft_entry__.entry()`` and ``dryrun_multichip()``.

``entry()`` returns ``(fn, args)`` as ``__graft_entry__.entry()`` does:
``fn`` is the ``inner`` of ``utils.planify.planified(step, solver, bie,
capture=False)`` (ipde_tpu's ``jit=False``) and ``args`` are ``(plans,
f_grid, f_radial)``; ``fn(*args)`` installs the plan tensors and runs one
full interior Poisson solve (box FFT solve, annular GMRES, QFS coupling,
layer potentials through the CUDA kernels) plus the Dirichlet BIE
correction at nb=128, M=8 on the card, and returns the corrected solution
on the grid.

``dryrun_multichip(n)`` runs one solve + BIE correction of the two-body
problem (an interior boundary and a same-shape inclusion, nb=128, M=6)
under ``use_mesh`` with a mesh of n shards (``parallel/sharded.py``):
target-sharded layer potentials and the lockstep annular GMRES split along
its boundary axis.  The shards go round-robin over the cards torch sees, so
on one card all n shards share it, and the step is planified (captured
once, then replayed), as ipde_tpu jits it; ``device="cpu"`` puts them all
on the CPU and runs the step eagerly.  ipde_tpu's virtual CPU devices
(``_pin_cpu_mesh``) have no counterpart.
"""

from __future__ import annotations

import numpy as np


def sol(x, y):
    return -np.cos(x) * np.exp(np.sin(x)) * np.sin(y)


def frc(x, y):
    return ((2.0 * np.cos(x) + 3.0 * np.cos(x) * np.sin(x) - np.cos(x) ** 3)
            * np.exp(np.sin(x)) * np.sin(y))


def build_problem(nb: int = 128, M: int = 8, device=None,
                  two_body: bool = False):
    """__graft_entry__._build_problem's Poisson problem on ``device``
    (None: the card): (solver, bie, f, bc); with ``two_body``, with its
    inclusion of the same (nb, M), which takes the lockstep annular GMRES."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import DirichletBIE
    from ipde_tpu_torch.solvers.scalar import PoissonSolver

    bdy = star(nb, a=0.1, f=3)
    # keep the annulus comfortably inside the curvature radius
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdys = [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)]
    if two_body:
        inc = star(nb, x=0.0, y=0.0, r=0.22, a=0.05, f=4)
        ebdys.append(EmbeddedBoundary(inc, False, M, bh, qfs_tolerance=1e-12))
    ebdyc = EmbeddedBoundaryCollection(ebdys, device=device)
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, frc)
    bc = BoundaryFunction.from_function(ebdyc, sol)
    solver = PoissonSolver(ebdyc)
    return solver, DirichletBIE(solver), f, bc


def entry(device=None):
    """(fn, args): ``fn(plans, f_grid, f_radial)`` is one full Poisson
    solve + apply_bc (GMRES tol 1e-12, maxiter 60, restart 30) with the
    plan tensors ``plans`` installed, returning the grid solution; ``args``
    are the plans of ``planified(step, solver, bie, capture=False)`` and
    the problem's forcing, on ``device`` (None: the card; raises without
    one)."""
    from ipde_tpu_torch.functions import EmbeddedFunction
    from ipde_tpu_torch.utils.planify import planified

    solver, bie, f, bc = build_problem(device=device)

    def step(f_grid, f_radial):
        ue = solver(EmbeddedFunction(f_grid, [f_radial]), tol=1e-12,
                    maxiter=60, restart=30)
        return bie.apply_bc(ue, bc).grid

    run = planified(step, solver, bie, capture=False)
    run.inner.solver = solver
    return run.inner, (run.plans, f.grid, f.radials[0])


def dryrun_multichip(n_devices: int, device=None):
    """One sharded solve + apply_bc (GMRES tol 1e-10, maxiter 40, restart
    20) of the two-body problem (nb=128, M=6) on a mesh of ``n_devices``
    shards: round-robin over the CUDA cards torch sees (raises without
    one), or all on ``device`` when given (e.g. ``"cpu"``).  On the cards
    the step runs as ``planified(step, solver, bie)``, the counterpart of
    ipde_tpu's ``jax.jit(step)`` under the mesh: a first call that
    captures it and replays, then a replay; raises unless the two results
    are finite and bit-equal.  On ``device`` it runs eagerly once; raises
    unless the result is finite.  Returns (the grid solution, the number
    of distinct devices of the mesh)."""
    import torch

    from ipde_tpu_torch.functions import EmbeddedFunction
    from ipde_tpu_torch.parallel.sharded import make_mesh
    from ipde_tpu_torch.utils.planify import planified

    if device is None:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("dryrun_multichip: torch sees no CUDA device; "
                               "pass device='cpu' for the CPU")
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    mesh = make_mesh(devices=devices)
    solver, bie, f, bc = build_problem(nb=128, M=6, device=mesh.lead,
                                       two_body=True)
    solver.use_mesh(mesh)

    def step(f_grid, *f_radials):
        ue = solver(EmbeddedFunction(f_grid, list(f_radials)), tol=1e-10,
                    maxiter=40, restart=20)
        return bie.apply_bc(ue, bc).grid

    args = (f.grid, *f.radials)
    if device is None:
        run = planified(step, solver, bie)
        grid, again = run(*args), run(*args)
        if not torch.equal(grid, again):
            raise RuntimeError("dryrun_multichip: two replays differ")
    else:
        grid = step(*args)
    if not bool(torch.isfinite(grid).all()):
        raise RuntimeError("dryrun_multichip: the solution is not finite")
    return grid, mesh.physical
