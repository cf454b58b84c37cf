"""Hold one output of the program to the reference.

``errors(eq, params, fields, geo, dtype)`` gives each of the equation's
``CHECKS``: the largest absolute error over every physical grid point and
every radial node of the fields it groups, a field of ``MEAN_FREE`` first
shifted by the mean over the physical grid points of its difference from
the reference (the solution fixes it only up to a constant).  ``fields``
maps a field name to (grid values, radial values), as NumPy arrays; a field
whose shape is not the reference's, or that is not finite, reads inf."""

import numpy as np


def field_errors(eq, params, fields, geo, dtype=np.float64):
    """{field: largest absolute error} of one output, ``dtype`` the
    precision the reference computes in (float64; the control's lower
    precision for ``control.py``)."""
    on_grid = eq.exact(params, geo.X[geo.phys], geo.Y[geo.phys], dtype)
    on_radial = eq.exact(params, geo.rx, geo.ry, dtype)
    out = {}
    for name in eq.FIELDS:
        g, r = fields[name]
        if g.shape != geo.X.shape or r.shape != geo.rx.shape:
            out[name] = float("inf")
            continue
        dg = g[geo.phys].astype(np.float64) - on_grid[name]
        dr = r.astype(np.float64) - on_radial[name]
        if name in eq.MEAN_FREE:
            shift = dg.mean()
            dg, dr = dg - shift, dr - shift
        err = max(np.abs(dg).max(initial=0.0), np.abs(dr).max(initial=0.0))
        out[name] = float(err) if np.isfinite(err) else float("inf")
    return out


def errors(eq, params, fields, geo, dtype=np.float64):
    per = field_errors(eq, params, fields, geo, dtype)
    return {check: max(per[f] for f in group)
            for check, group in eq.CHECKS.items()}
