"""Moving-boundary advection-diffusion timestepping
(ipde_tpu.advection.stepper.CoupledAdvectionDiffusionStepper, on torch).

Each step is ipde_tpu's: a host geometry rebuild and departure-point
solve, the advection of the field, then the implicit diffusion solve on
the new geometry (reference: examples/semi_lagrangian_experiments/
coupled_simplify*.py).  As in ipde_tpu, the advection and the solve run
through ``utils/planify.py``: the first step captures each (on a card, as
CUDA graphs), every later step ``replan``s the rebuilt advector, solver and
BIE into the captured programs.  ``pad_quantum`` keeps their plan shapes
step-invariant; a shape miss captures again once and is counted in
``recompiles`` and logged in ``miss_log``.  The solver's ``helpers=`` reuse
carries the annular preconditioners from step to step at fixed (n, M).
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
from ipde_tpu_torch.utils.planify import planified, replan


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
    seconds of the last step, each read after the device has finished;
    advect_s and solve_s include their replan), ``helpers``,
    ``recompiles`` (replan shape misses, each captured again; should stay
    0) and ``miss_log`` (the message of every miss).  ``last_replan_s``
    holds the seconds of the last step's two replans.  ``planify=False``
    runs every step eagerly instead (what the planified steps are held
    to).
    """

    def __init__(self, ebdyc, velocity: Callable, nu: float, dt: float,
                 tol: float = 1e-12, maxiter: int = 100, restart: int = 30,
                 bc: str = "neumann", planify: bool = True):
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
        self.planify = planify
        self._jadvect = None
        self._jsolve = None
        self.last_times = {}
        self.last_replan_s = 0.0
        self.recompiles = 0     # replan shape misses (should stay 0)
        self.miss_log = []      # messages of every shape miss

    def _clock(self) -> float:
        """Host wall time once the collection's device has finished."""
        if self.ebdyc.device.type == "cuda":
            torch.cuda.synchronize(self.ebdyc.device)
        return time.perf_counter()

    # -- the two programs ---------------------------------------------------
    @staticmethod
    def _advect_program(adv):
        def apply_(cg, *cr):
            out = adv(EmbeddedFunction(cg, list(cr)))
            return (out.grid, *out.radials)
        return apply_

    def _solve_program(self, solver, bie, bcn):
        k2 = self.k ** 2
        tol, maxiter, restart = self.tol, self.maxiter, self.restart

        def apply_(cg, *cr):
            f = EmbeddedFunction(cg * k2, [r * k2 for r in cr])
            ue, _ = solver.solve_with_stats(f, tol=tol, maxiter=maxiter,
                                            restart=restart)
            ue = bie.apply_bc(ue, bcn)
            return (ue.grid, *ue.radials)
        return apply_

    def _program(self, name, make, *roots):
        """The planified program ``name`` (_jadvect or _jsolve) pointed at
        ``roots``: made at the first step, replanned after; a replan shape
        miss makes it again (captured again at its first call)."""
        call = getattr(self, name)
        if call is not None:
            t0 = time.perf_counter()
            try:
                replan(call, *roots)
                self.last_replan_s += time.perf_counter() - t0
                return call
            except ValueError as e:
                self.recompiles += 1
                self.miss_log.append(f"{name[2:]}: {e}")
        call = planified(make(), *roots)
        setattr(self, name, call)
        return call

    def step(self, c: EmbeddedFunction) -> EmbeddedFunction:
        """Advance c one dt on a moving geometry; self.ebdyc is updated to
        the new geometry.  Returns c^{n+1}."""
        ebdyc = self.ebdyc
        self.last_replan_s = 0.0
        t0 = self._clock()
        u, v = self.velocity(ebdyc)
        adv = SemiLagrangianAdvector(ebdyc, u, v)
        new_ebdyc = adv.generate(self.dt, fixed_grid=True)
        t1 = self._clock()
        if self.planify:
            run = self._program("_jadvect",
                                lambda: self._advect_program(adv), adv)
            out = run(c.grid, *c.radials)
            c_star = EmbeddedFunction(out[0], list(out[1:]))
        else:
            c_star = adv(c)
        t2 = self._clock()
        solver = ModifiedHelmholtzSolver(new_ebdyc, k=self.k,
                                         helpers=self.helpers)
        self.helpers = solver.helpers
        bie = NeumannBIE(solver)
        t3 = self._clock()
        if self._jsolve is None or not self.planify:
            self._bcn = BoundaryFunction([
                torch.zeros(e.bdy.N, dtype=torch.float64,
                            device=new_ebdyc.device) for e in new_ebdyc])
        if self.planify:
            run = self._program(
                "_jsolve", lambda: self._solve_program(solver, bie,
                                                       self._bcn),
                solver, bie)
            out = run(c_star.grid, *c_star.radials)
            c_new = EmbeddedFunction(out[0], list(out[1:]))
        else:
            c_new = self._solve_program(solver, bie, self._bcn)(
                c_star.grid, *c_star.radials)
            c_new = EmbeddedFunction(c_new[0], list(c_new[1:]))
        t4 = self._clock()
        self.ebdyc = new_ebdyc
        self.last_times = {"generate_s": round(t1 - t0, 3),
                           "advect_s": round(t2 - t1, 3),
                           "setup_s": round(t3 - t2, 3),
                           "solve_s": round(t4 - t3, 3)}
        return c_new
