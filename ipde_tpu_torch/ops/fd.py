"""4th-order centered finite differences on the periodic background grid.

Reference: ipde/derivatives.py:3-28 (fd_x_4 / fd_y_4 with periodic_fix).
The box is periodic by construction, so the wrap is always applied
(``torch.roll``); axis 0 is x, axis 1 is y, as in ipde_tpu.ops.fd.
"""

from __future__ import annotations

import torch


def fd_x_4(f: torch.Tensor, h: float) -> torch.Tensor:
    """4th-order d/dx (axis 0) of periodic grid data."""
    return (-torch.roll(f, -2, 0) + 8 * torch.roll(f, -1, 0)
            - 8 * torch.roll(f, 1, 0) + torch.roll(f, 2, 0)) / (12.0 * h)


def fd_y_4(f: torch.Tensor, h: float) -> torch.Tensor:
    """4th-order d/dy (axis 1) of periodic grid data."""
    return (-torch.roll(f, -2, 1) + 8 * torch.roll(f, -1, 1)
            - 8 * torch.roll(f, 1, 1) + torch.roll(f, 2, 1)) / (12.0 * h)


def fd_xx_4(f: torch.Tensor, h: float) -> torch.Tensor:
    """4th-order d2/dx2 (axis 0) of periodic grid data."""
    return (-torch.roll(f, -2, 0) + 16 * torch.roll(f, -1, 0) - 30 * f
            + 16 * torch.roll(f, 1, 0) - torch.roll(f, 2, 0)) / (12.0 * h * h)


def fd_yy_4(f: torch.Tensor, h: float) -> torch.Tensor:
    """4th-order d2/dy2 (axis 1) of periodic grid data."""
    return (-torch.roll(f, -2, 1) + 16 * torch.roll(f, -1, 1) - 30 * f
            + 16 * torch.roll(f, 1, 1) - torch.roll(f, 2, 1)) / (12.0 * h * h)
