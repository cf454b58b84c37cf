"""Moving-boundary advection-diffusion timestepping
(ipde_tpu.advection.stepper.CoupledAdvectionDiffusionStepper, on torch).

Each step is the eager recipe of ipde_tpu's stepper (reference:
examples/semi_lagrangian_experiments/coupled_simplify*.py): a host geometry
rebuild and departure-point solve, the advection of the field, then the
implicit diffusion solve on the new geometry.  ipde_tpu swaps the rebuilt
plan arrays into compiled programs (utils/planify.py, a TPU recompile
workaround that is not ported); here each step calls the advector,
``ModifiedHelmholtzSolver`` and ``NeumannBIE`` directly, on the
collection's device.  What carries over from step to step is the solver's
``helpers=`` reuse: the annular preconditioners survive regeneration at
fixed (n, M).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ipde_tpu_torch.advection.semi_lagrangian import SemiLagrangianAdvector
from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
from ipde_tpu_torch.solvers.bie import NeumannBIE
from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver


class CoupledAdvectionDiffusionStepper:
    """FE semi-Lagrangian advection + backward-Euler diffusion:
        c_t + u . grad(c) = nu lap(c),   boundary moving with u,
        (I - dt nu lap) c^{n+1} = c^n(x_d)  -- an MH solve, k^2 = 1/(dt nu).

    velocity: callable (ebdyc) -> (u, v) EmbeddedFunctions for the current
    geometry (prescribed velocity; a flow solved from a PDE can be fed the
    same way).  The background grid is FIXED (generate it once, roomy
    enough for the whole trajectory, with ``pad_quantum``) so every step
    reuses the same box.

    tol is the annular GMRES tolerance (default 1e-12, as in ipde_tpu).
    The port's GMRES checks its TRUE residual against tol and raises above
    it; its float64 floor is about 3e-14, so a tol of 1e-14 raises instead
    of returning a solution: use tol >= 1e-13.

    The attributes that calling scripts read are those of ipde_tpu:
    ``last_times`` (generate_s, advect_s, setup_s, solve_s: host wall
    seconds of the last step, each read after the device has finished),
    ``helpers``, ``recompiles`` (always 0: nothing is compiled per shape)
    and ``miss_log`` (always empty).
    """

    def __init__(self, ebdyc, velocity: Callable, nu: float, dt: float,
                 tol: float = 1e-12, maxiter: int = 100, restart: int = 30,
                 bc: str = "neumann"):
        if getattr(ebdyc, "pad_quantum", None) is None:
            raise ValueError(
                "stepper requires a pad_quantum-registered grid "
                "(generate_grid(..., pad_quantum=...)), as ipde_tpu's does")
        self.ebdyc = ebdyc
        self.velocity = velocity
        self.nu = nu
        self.dt = dt
        self.k = float(np.sqrt(1.0 / (dt * nu)))
        self.tol, self.maxiter, self.restart = tol, maxiter, restart
        if bc != "neumann":
            raise NotImplementedError("only no-flux (neumann) BC wired up")
        self.helpers = None
        self.last_times = {}
        self.recompiles = 0
        self.miss_log = []

    def _clock(self) -> float:
        """Host wall time once the collection's device has finished."""
        if self.ebdyc.device.type == "cuda":
            torch.cuda.synchronize(self.ebdyc.device)
        return time.perf_counter()

    def step(self, c: EmbeddedFunction) -> EmbeddedFunction:
        """Advance c one dt on a moving geometry; self.ebdyc is updated to
        the new geometry.  Returns c^{n+1}."""
        ebdyc = self.ebdyc
        t0 = self._clock()
        u, v = self.velocity(ebdyc)
        adv = SemiLagrangianAdvector(ebdyc, u, v)
        new_ebdyc = adv.generate(self.dt, fixed_grid=True)
        t1 = self._clock()
        c_star = adv(c)
        t2 = self._clock()
        solver = ModifiedHelmholtzSolver(new_ebdyc, k=self.k,
                                         helpers=self.helpers)
        self.helpers = solver.helpers
        bie = NeumannBIE(solver)
        bcn = BoundaryFunction([torch.zeros(e.bdy.N, dtype=torch.float64,
                                            device=new_ebdyc.device)
                                for e in new_ebdyc])
        t3 = self._clock()
        ue = solver(c_star * self.k ** 2, tol=self.tol, maxiter=self.maxiter,
                    restart=self.restart)
        c_new = bie.apply_bc(ue, bcn)
        t4 = self._clock()
        self.ebdyc = new_ebdyc
        self.last_times = {"generate_s": round(t1 - t0, 3),
                           "advect_s": round(t2 - t1, 3),
                           "setup_s": round(t3 - t2, 3),
                           "solve_s": round(t4 - t3, 3)}
        return c_new
