"""The planified step: one solve + ``apply_bc`` as ``planified`` takes it.

Frozen copy of ``chip_smoke.py::plan_step``, rewritten so that the boundary
data is an argument of the step and not a constant of its closure: a
caller hands in a new right-hand side and new boundary data at every call,
and ``replan`` of a rebuilt solver and BIE reaches everything else."""


def plan_step(solver, bie, n_forcing, n_boundary, gmres):
    """fn(*args) -> ([every output field's grid and radials], stats).

    ``args``: for each of the ``n_forcing`` forcing components its grid and
    one radial per boundary, then for each of the ``n_boundary``
    boundary-data components one value tensor per boundary.  ``gmres``:
    the solver's tol, maxiter and restart."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    nb = len(solver.ebdyc.ebdys)
    k = 1 + nb

    def fn(*a):
        fs = [EmbeddedFunction(a[i * k], list(a[i * k + 1:(i + 1) * k]))
              for i in range(n_forcing)]
        o = n_forcing * k
        bcs = [BoundaryFunction(list(a[o + j * nb:o + (j + 1) * nb]))
               for j in range(n_boundary)]
        out, st = solver.solve_with_stats(*fs, **gmres)
        out = bie.apply_bc(*(out if isinstance(out, tuple) else (out,)),
                           *bcs)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [t for ef in out for t in (ef.grid, *ef.radials)], st
    return fn
