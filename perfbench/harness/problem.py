"""The program under test, built from a configuration file alone.

A configuration names the boundary, M, the sizing rule, the QFS tolerance,
the solver and BIE classes (dotted names in ``ipde_tpu_torch``), the grid
and set-up backends and GMRES's settings; the traffic mix may add a
``pad_quantum`` for the registrations.  ``Geometry``
makes the boundary and registers the box grid (``generate_grid``; a moved
boundary keeps the set-up grid and is registered on it, as
``advection/stepper.py`` does), ``solve_objects`` the solver and its BIE.
``inputs`` evaluates a right-hand side on the card, where the program will
read it: the forcing at the physical grid points (0 elsewhere, as
``EmbeddedFunction.from_function`` makes it) and the radial nodes, the
boundary data at the boundary nodes."""

import importlib

import numpy as np
import torch


def _class(dotted):
    mod, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


class Geometry:
    """The program's geometry of one boundary position, and the device
    coordinates its inputs are evaluated at."""

    def __init__(self, cfg, dev, rot=0.0, base=None, pad_quantum=None):
        from ipde_tpu_torch.geometry import curve as curves
        from ipde_tpu_torch.geometry.collection import \
            EmbeddedBoundaryCollection
        from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
        b, m = cfg["boundary"], cfg["M"]
        bdy = getattr(curves, b["curve"])(
            b["N"], x=b["x"], y=b["y"], r=b["r"], a=b["a"], f=b["f"],
            rot=rot)
        if base is None:
            s = cfg["sizing"]
            h = min(bdy.min_h(),
                    s["curvature_factor"] / np.abs(bdy.curvature).max() / m)
            if s.get("grid_target"):
                h = min(h, float(bdy.x.max() - bdy.x.min())
                        / (s["grid_target"] - 3 * m))
        else:
            h = base.h
        self.h = h
        ebdy = EmbeddedBoundary(bdy, True, m, h,
                                qfs_tolerance=cfg["qfs_tolerance"])
        self.ebdyc = EmbeddedBoundaryCollection([ebdy], device=dev)
        if base is None:
            self.grid = self.ebdyc.generate_grid(
                h, pad_quantum=pad_quantum)
            g = self.grid
            self.xg = torch.as_tensor(np.ascontiguousarray(g.xg), device=dev)
            self.yg = torch.as_tensor(np.ascontiguousarray(g.yg), device=dev)
        else:
            self.grid = base.grid
            self.ebdyc.register_grid(self.grid, pad_quantum=pad_quantum)
            self.ebdyc.bump_location = base.ebdyc.bump_location
            self.xg, self.yg = base.xg, base.yg
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.radial = [(as_dev(e.radial_x), as_dev(e.radial_y))
                       for e in self.ebdyc]
        self.bdy = [(as_dev(e.bdy.x), as_dev(e.bdy.y)) for e in self.ebdyc]


def solve_objects(cfg, geo):
    """(solver, bie) of the configuration on ``geo``."""
    solver = _class(cfg["solver"])(geo.ebdyc, **cfg.get("solver_kw", {}))
    return solver, _class(cfg["bie"])(solver)


def inputs(eq, params, geo):
    """The flat argument list of ``planstep.plan_step``'s step."""
    phys = geo.ebdyc.phys_dev
    on_grid = eq.forcing(params, geo.xg, geo.yg, torch)
    on_radial = [eq.forcing(params, x, y, torch) for x, y in geo.radial]
    on_bdy = [eq.boundary(params, x, y, torch) for x, y in geo.bdy]
    args = []
    for c in range(eq.FORCING):
        args.append(torch.where(phys, on_grid[c], 0.0).contiguous())
        args.extend(r[c].contiguous() for r in on_radial)
    for c in range(eq.BOUNDARY):
        args.extend(v[c].contiguous() for v in on_bdy)
    return args


def plan(fn, *roots):
    """``planified(fn, *roots)``: the program's own, captured at the first
    call on a card."""
    from ipde_tpu_torch.utils.planify import planified
    return planified(fn, *roots)


def replan(call, *roots):
    from ipde_tpu_torch.utils.planify import replan as program_replan
    return program_replan(call, *roots)
