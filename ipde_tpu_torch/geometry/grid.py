"""Uniform Cartesian grid (periodic box) the domain is embedded into.

Replaces the reference's external pybie2d.grid.Grid surface
(x_bounds, Nx, xv/yv, xg/yg, xh, shape; SURVEY.md section 2.2).
"""

from __future__ import annotations

import numpy as np


class Grid:
    """Uniform grid on [x0, x1) x [y0, y1): endpoints excluded on the right
    (periodic convention, matching the reference's
    x_endpoints=[True, False])."""

    def __init__(self, x_bounds, Nx: int, y_bounds, Ny: int):
        self.x_bounds = tuple(map(float, x_bounds))
        self.y_bounds = tuple(map(float, y_bounds))
        self.Nx = int(Nx)
        self.Ny = int(Ny)
        self.xh = (self.x_bounds[1] - self.x_bounds[0]) / self.Nx
        self.yh = (self.y_bounds[1] - self.y_bounds[0]) / self.Ny
        self.xv = self.x_bounds[0] + np.arange(self.Nx) * self.xh
        self.yv = self.y_bounds[0] + np.arange(self.Ny) * self.yh
        self.shape = (self.Nx, self.Ny)

    @property
    def xg(self):
        return np.broadcast_to(self.xv[:, None], self.shape)

    @property
    def yg(self):
        return np.broadcast_to(self.yv[None, :], self.shape)

    @property
    def x_period(self):
        return self.x_bounds[1] - self.x_bounds[0]

    @property
    def y_period(self):
        return self.y_bounds[1] - self.y_bounds[0]
