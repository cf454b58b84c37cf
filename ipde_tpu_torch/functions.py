"""EmbeddedFunction / BoundaryFunction: the framework's data types, on tensors.

A function on the embedded domain is (full background grid values, one radial
(M, N) tensor per boundary).  The grid tensor is the FULL (Nx, Ny) array
(zeros in the exterior).  Tensors live on the collection's device in float64.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ipde_tpu_torch.config import require_cuda


def _f64(a, device):
    return torch.tensor(np.asarray(a, np.float64), device=device)


class EmbeddedFunction:
    """grid: (Nx, Ny) values (zero outside the physical domain);
    radials: tuple of per-boundary (M, N_b) radial grid values."""

    def __init__(self, grid, radials: Sequence):
        self.grid = grid
        self.radials = tuple(radials)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_function(cls, ebdyc, f: Callable) -> "EmbeddedFunction":
        """Evaluate f(x, y) (numpy in, numpy out) on the physical grid points
        and radial grids; the result lives on ``ebdyc.device``."""
        g = np.zeros(ebdyc.grid.shape)
        g[ebdyc.phys] = f(ebdyc.grid.xg[ebdyc.phys], ebdyc.grid.yg[ebdyc.phys])
        radials = [f(e.radial_x, e.radial_y) for e in ebdyc]
        return cls(_f64(g, ebdyc.device),
                   [_f64(r, ebdyc.device) for r in radials])

    @classmethod
    def zeros(cls, ebdyc) -> "EmbeddedFunction":
        kw = {"dtype": torch.float64, "device": ebdyc.device}
        return cls(torch.zeros(ebdyc.grid.shape, **kw),
                   [torch.zeros(e.radial_shape, **kw) for e in ebdyc])

    # -- arithmetic (elementwise over leaves) ----------------------------------
    def _binop(self, o, op):
        if isinstance(o, EmbeddedFunction):
            return EmbeddedFunction(op(self.grid, o.grid),
                                    [op(a, b) for a, b in
                                     zip(self.radials, o.radials)])
        return EmbeddedFunction(op(self.grid, o),
                                [op(a, o) for a in self.radials])

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __neg__(self):
        return self._binop(-1.0, lambda a, b: a * b)

    def __abs__(self):
        return EmbeddedFunction(self.grid.abs(),
                                [a.abs() for a in self.radials])

    def max(self):
        m = self.grid.max()
        for a in self.radials:
            m = torch.maximum(m, a.max())
        return m

    def max_on(self, ebdyc):
        """Max over physical points only."""
        m = self.grid[ebdyc.phys_dev].max()
        for a in self.radials:
            m = torch.maximum(m, a.max())
        return m

    def get_grid_value(self, ebdyc, masked: bool = False):
        """Grid values with exterior points zeroed (reference:
        ipde/embedded_function.py:184-189).  ``masked=True`` returns a
        numpy masked array hiding the exterior."""
        arr = torch.where(ebdyc.phys_dev, self.grid, 0.0)
        if masked:
            return np.ma.array(arr.cpu().numpy(), mask=~ebdyc.phys)
        return arr

    def get_smoothed_grid_value(self, ebdyc):
        """Grid values rolled off smoothly to zero across the annulus via
        the collection's smooth step (reference:
        ipde/embedded_function.py:190-194)."""
        return self.grid * ebdyc.grid_step_dev

    def __repr__(self):
        return (f"EmbeddedFunction(grid={tuple(self.grid.shape)}, "
                f"radials={[tuple(r.shape) for r in self.radials]})")

    # -- persistence -----------------------------------------------------------
    def save(self) -> dict:
        return {"grid": self.grid.cpu().numpy(),
                "radials": [r.cpu().numpy() for r in self.radials]}

    @classmethod
    def load(cls, d: dict, device=None) -> "EmbeddedFunction":
        """Accepts the dict of either package's ``save``; ``device`` None
        means the CUDA card (``config.require_cuda``)."""
        if device is None:
            device = require_cuda()
        return cls(_f64(d["grid"], device),
                   [_f64(r, device) for r in d["radials"]])


class BoundaryFunction:
    """One value tensor per boundary (tuple of (N_b,) tensors)."""

    def __init__(self, values: Sequence):
        self.values = tuple(values)

    @classmethod
    def from_function(cls, ebdyc, f: Callable) -> "BoundaryFunction":
        return cls([_f64(f(e.bdy.x, e.bdy.y), ebdyc.device) for e in ebdyc])

    def concat(self):
        return torch.cat(self.values)

    def _binop(self, o, op):
        if isinstance(o, BoundaryFunction):
            return BoundaryFunction([op(a, b) for a, b in
                                     zip(self.values, o.values)])
        return BoundaryFunction([op(a, o) for a in self.values])

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __getitem__(self, i):
        return self.values[i]
