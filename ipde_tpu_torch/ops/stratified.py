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
groups are fixed at plan-build time: the distance search that sets them
runs on the plan's device, the stride rule on the host; each group is one
dense apply.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ipde_tpu_torch.utils.profiling import count, spanned

# (target, coarse source) pairs in one row chunk of the distance search:
# each of its two temporaries holds that many doubles (64 MB)
SEARCH_PAIRS_PER_CHUNK = 1 << 23


def _row_minima(tx, ty, sx, sy, n: int) -> np.ndarray:
    """The minimum over each radial row (``n`` consecutive targets) of the
    squared distance from a target to the source curve, read back to the
    host: a coarse argmin over every cs-th source, then the exact minimum
    in a +-cs index window around the winner (the distance-to-curve field
    is smooth along the source index, so the window contains the true
    minimum).  Runs on the tensors' device, in chunks of whole rows of at
    most ``SEARCH_PAIRS_PER_CHUNK`` coarse pairs.  Products and sums are
    separate operations and ``argmin`` takes the first minimum, as NumPy's
    does, so every value is bit-equal to a NumPy search's."""
    N = sx.numel()
    M = tx.numel() // n
    cs = max(1, N // 256)
    csx, csy = sx[::cs], sy[::cs]
    win = torch.arange(-cs, cs + 1, device=sx.device)
    rows = max(1, SEARCH_PAIRS_PER_CHUNK // (n * csx.numel()))
    out = torch.empty(M, dtype=tx.dtype, device=tx.device)
    for r in range(0, M, rows):
        t = slice(r * n, min(r + rows, M) * n)
        cx, cy = tx[t, None], ty[t, None]
        q, dy = cx - csx, cy - csy
        q.mul_(q).add_(dy.mul_(dy))
        jw = torch.remainder(q.argmin(1, keepdim=True) * cs + win, N)
        q, dy = cx - sx[jw], cy - sy[jw]
        q.mul_(q).add_(dy.mul_(dy))
        out[r:r + rows] = q.amin(1).view(-1, n).amin(1)
    count("stratified.search_pairs", M * n * (csx.numel() + 2 * cs + 1))
    return out.cpu().numpy()


class StratifiedRadialApply:
    """Plan for applying a kernel from a source curve to an (M, n) radial
    grid with per-row source subsampling.

    src: curve-like with host .x, .y, .weights, .N (a QFS source curve).
    radial_x/y: (M, n) host radial node coordinates.
    k_density: band limit of densities that will be applied (modes above
    this are assumed at/below the tolerance floor already).
    exponent: required decay exponent (30 ~ 1e-13).
    device: where the plan's coordinate tensors live, and where the
    distance search that sets the strides runs.
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
        T = M * n
        self.shape = (M, n)
        # the radial nodes and the source curve on the device, one copy
        coords = torch.as_tensor(np.concatenate(
            [radial_x.ravel(), radial_y.ravel(), sx, sy, sw]), device=device)
        tx, ty = coords[:T], coords[T:2 * T]
        dsx, dsy, dsw = coords[2 * T:].view(3, N)
        strides = np.ones(M, np.int64)
        # the search only where some row can take a stride of 2
        if max_stride >= 2 and N // 2 >= min_points:
            # per-row distance to the source curve, less a safety h_s
            L = float(sw.sum())           # curve length (weights ~ ds)
            d = np.sqrt(_row_minima(tx, ty, dsx, dsy, n)) - L / N
            d = np.maximum(d, 0.0)
            # analyticity-strip half-width in the curve PARAMETER: a = d /
            # vmax (vmax = max |z'(theta)|, NOT the mean L/2pi -- for
            # non-circular curves the strip is set by the fastest-moving
            # stretch)
            vmax = float(sw.max()) * N / (2.0 * np.pi)
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
        fs = sorted(set(strides.tolist()))
        order = [np.flatnonzero(strides == f) for f in fs]
        row_order = np.concatenate(order)
        inv = np.empty(M, np.int64)
        inv[row_order] = np.arange(M)
        index = torch.as_tensor(np.concatenate([row_order, inv]),
                                device=device)
        self._inv_rows = index[M:]
        tx, ty = tx.view(M, n), ty.view(M, n)
        groups = []
        start = 0
        for f, rows in zip(fs, order):
            sel = index[start:start + rows.size]
            start += rows.size
            groups.append((int(f), tx[sel].reshape(-1), ty[sel].reshape(-1),
                           dsx[::f].clone(), dsy[::f].clone(), dsw[::f] * f))
        self.groups = groups

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
