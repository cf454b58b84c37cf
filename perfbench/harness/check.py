"""Decide ``correct``: the outputs the window kept, held to the plain
reference once the program's state is freed.

Each kept output is (call index, bank index, angle, {field: (grid,
radials)}) on the host.  The reference (``perfbench/reference``) works out
that call's geometry again from the configuration and the angle, and
evaluates the right-hand side's solution there; every check of the
equation is the largest error over the kept outputs, held to the
configuration's ``limits``."""

import numpy as np

from perfbench.reference.compare import errors
from perfbench.reference.geometry import Geometry


def as_fields(eq, flat):
    """{field: (grid, radial)} of one output's flat list (one boundary)."""
    return {name: (flat[2 * i], flat[2 * i + 1])
            for i, name in enumerate(eq.FIELDS)}


def worst_errors(cell, bank, kept):
    """{check: largest error over the kept outputs}."""
    worst = {name: 0.0 for name in cell.equation.CHECKS}
    geos = {}
    for _, idx, rot, fields in kept:
        geo = geos.get(rot)
        if geo is None:
            geo = geos[rot] = Geometry(cell.cfg, rot)
        for name, v in errors(cell.equation, bank[idx], fields, geo).items():
            worst[name] = max(worst[name], v)
    return worst


def verdict(cell, worst, attempted, failed, kept):
    """(correct, {check: {"value", "limit"}})."""
    limits = cell.cfg["limits"]
    checks = {name: {"value": worst[name], "limit": limits[name]}
              for name in cell.equation.CHECKS}
    ok = (attempted > 0 and failed == 0 and len(kept) > 0
          and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()))
    return ok, checks
