"""Stratified source subsampling for dense source-curve -> radial-grid
layer-potential applies.

The two dense phases of a solve that target the radial grids (the helper
'correct' pass and the BIE radial evaluation; reference analogues
ipde/solvers/internals/scalar.py:111-113 and the examples' BIE glue)
evaluate a layer potential from a closed QFS source curve at every node of an
annular radial grid.  The integrand for a target at distance d from the
source curve is analytic in a parameter strip of half-width ~ 2 pi d / L, so
the trapezoid/Fourier quadrature error of an N_f-point subsampling decays
like

    exp(-(2 pi d / L) (N_f - k_sigma)),

with k_sigma the density's band limit (QFS maps are rule-36 filtered on the
underlying curve's modes).  Radial rows far from the source curve therefore
need far fewer source points: subsample the sources by a per-row power-of-2
stride chosen so the bound above is below the solve tolerance.  The row
groups are fixed at plan-build time (host); each group is one dense apply.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ipde_tpu_torch.utils.profiling import spanned


class StratifiedRadialApply:
    """Plan for applying a kernel from a source curve to an (M, n) radial
    grid with per-row source subsampling.

    src: curve-like with host .x, .y, .weights, .N (a QFS source curve).
    radial_x/y: (M, n) host radial node coordinates.
    k_density: band limit of densities that will be applied (modes above
    this are assumed at/below the tolerance floor already).
    exponent: required decay exponent (30 ~ 1e-13).
    device: where the plan's coordinate tensors live.
    """

    @spanned("setup.radial_plans")
    def __init__(self, src, radial_x, radial_y, k_density: int,
                 exponent: float = 30.0, max_stride: int = 16,
                 min_points: int = 64, *, device):
        sx = np.asarray(src.x, np.float64)
        sy = np.asarray(src.y, np.float64)
        sw = np.asarray(src.weights, np.float64)
        N = sx.size
        radial_x = np.asarray(radial_x, np.float64)
        radial_y = np.asarray(radial_y, np.float64)
        M, n = radial_x.shape
        self.shape = (M, n)
        L = float(sw.sum())               # curve length (weights ~ ds)
        # per-row minimum distance to the source curve: coarse argmin over
        # subsampled sources, then exact refine in a +-cs index window
        # around the winner (the distance-to-curve field is smooth along
        # the source index, so the window contains the true minimum)
        cs = max(1, N // 256)
        h_s = L / N
        tx_all = radial_x.reshape(-1)
        ty_all = radial_y.reshape(-1)
        dx = tx_all[:, None] - sx[None, ::cs]
        dy = ty_all[:, None] - sy[None, ::cs]
        j0 = np.argmin(dx * dx + dy * dy, axis=1) * cs          # (T,)
        win = np.arange(-cs, cs + 1)
        jw = np.mod(j0[:, None] + win[None, :], N)              # (T, 2cs+1)
        dxw = tx_all[:, None] - sx[jw]
        dyw = ty_all[:, None] - sy[jw]
        dmin = np.sqrt((dxw * dxw + dyw * dyw).min(axis=1))
        d = dmin.reshape(M, n).min(axis=1) - h_s                # safety h_s
        d = np.maximum(d, 0.0)
        # analyticity-strip half-width in the curve PARAMETER: a = d / vmax
        # (vmax = max |z'(theta)|, NOT the mean L/2pi -- for non-circular
        # curves the strip is set by the fastest-moving stretch)
        vmax = float(sw.max()) * N / (2.0 * np.pi)
        strides = np.ones(M, np.int64)
        for m in range(M):
            f = 1
            while (2 * f <= max_stride and N // (2 * f) >= min_points
                   and (d[m] / vmax) * (N // (2 * f) - k_density)
                   >= exponent):
                f *= 2
            strides[m] = f
        self.strides = strides
        self.pair_fraction = float(np.sum(1.0 / strides) / M)
        # group rows by stride; remember the row order for scatter-back
        dev = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), device=device)
        groups = []
        order = []
        for f in sorted(set(strides.tolist())):
            rows = np.flatnonzero(strides == f)
            order.append(rows)
            groups.append((int(f), dev(radial_x[rows].ravel()),
                           dev(radial_y[rows].ravel()), dev(sx[::f]),
                           dev(sy[::f]), dev(sw[::f] * f)))
        self.groups = groups
        row_order = np.concatenate(order)
        inv = np.empty(M, np.int64)
        inv[row_order] = np.arange(M)
        self._inv_rows = dev(inv)

    def apply(self, fn: Callable, n_out: int = 1):
        """fn(sx, sy, wscale, stride, tx, ty) -> (T,) tensor, or a tuple of
        ``n_out`` (T,) tensors; returns the (M, n) result(s) in radial-row
        order.  ``wscale`` is the strided quadrature weights (already scaled
        by the stride); the caller multiplies its strided density by it."""
        n = self.shape[1]
        outs = [fn(gsx, gsy, gw, f, tx, ty)
                for f, tx, ty, gsx, gsy, gw in self.groups]
        if n_out == 1:
            return torch.cat([o.reshape(-1, n) for o in outs])[self._inv_rows]
        return tuple(torch.cat([o[j].reshape(-1, n) for o in outs])
                     [self._inv_rows] for j in range(n_out))
