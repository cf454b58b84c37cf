"""Partition of arbitrary point sets against an embedded boundary collection.

Zones (reference: EmbeddedPointPartition, ipde/ebdy_collection.py:37-218):
  zone 1: physical, in no annulus       -> spectral grid interpolation
  zone 2: physical, inside an annulus   -> radial Chebyshev-Fourier interp
  zone 3: not physical                  -> ``exterior_value`` (NaN by
          default), or boundary-coordinate extrapolation data for the
          semi-Lagrangian machinery

The classification runs on the host (Newton coordinates, even-odd test), as
in ipde_tpu.geometry.partition; the interpolation plans and their apply live
on the collection's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ipde_tpu_torch.functions import EmbeddedFunction
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                pad_index_set, set_flat)
from ipde_tpu_torch.geometry.coords import (compute_local_coordinates,
                                            points_inside_curve,
                                            points_near_curve)
from ipde_tpu_torch.ops.interp import PeriodicInterpolator2D, make_interpolator


class PointPartition:
    """Classify a point set and build its interpolation plans
    (ipde_tpu.geometry.partition.PointPartition).

    extra_capture widens the near-curve capture band beyond the annulus
    (radial_width * 1.05 + extra_capture): build the partition of QUERY
    points with extra_capture >= the maximum later point displacement, and
    pass it as ``seed`` when partitioning the DISPLACED points (departure
    points).  A seeded partition skips the KDTree sweep AND the even-odd
    physicality test: candidates come from the seed's near set, Newton
    starts from the seed's coordinates, and far points inherit the seed's
    per-boundary physicality (valid because any point whose side changed
    must lie within the seed's capture band).  Reference analogue: the
    danger-zone guess reuse of ipde/ebdy_collection.py:651-707.

    pad_quantum: the zone index sets and plan target lists are padded to
    the next multiple, as in ipde_tpu (plan targets repeat the first real
    target, or 0 when the zone is empty; scatter indices get the
    out-of-range sentinel n, which the scatters here drop).
    """

    def __init__(self, ebdyc: EmbeddedBoundaryCollection, x, y,
                 fix_r: bool = False, fix_r_band: float = 1e-8,
                 extra_capture: float = 0.0,
                 seed: "PointPartition" = None,
                 pad_quantum: int = None):
        self.ebdyc = ebdyc
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        self.x, self.y = x, y
        n = x.size
        phys = np.ones(n, dtype=bool)
        in_annulus = np.zeros(n, dtype=bool)
        self.extra_capture = extra_capture
        self.zone2 = []      # per ebdy: (indices, theta(r), t)
        self.zone3 = []      # per ebdy: (indices, t, r) of its aphysical pts
        self.full_t = []     # per ebdy: (t, r) for every point (exact for
        self.full_r = []     # near points, nearest-node guess otherwise)
        self.near_masks = []  # per ebdy: Newton candidate set
        self.per_phys = []    # per ebdy: physicality factor of every point
        if seed is not None and seed.x.size != n:
            raise ValueError("seed partition must cover the same point set")
        for i_e, e in enumerate(ebdyc):
            if seed is not None:
                near = seed.near_masks[i_e]
                guess_t = seed.full_t[i_e]
            else:
                near, guess_t = points_near_curve(
                    e.bdy, x, y, e.radial_width * 1.05 + extra_capture)
            idx = np.flatnonzero(near)
            res = compute_local_coordinates(e.bdy, x[idx], y[idx],
                                            guess_t[idx],
                                            e.coordinate_tolerance)
            r = res.r.copy()
            t = res.t
            if fix_r:
                if e.interior:
                    r[(r > 0) & (r < e.radial_width)] = 0.0
                else:
                    r[(r < 0) & (r > -e.radial_width)] = 0.0
            if e.interior:
                in_ann = (r <= 0) & (r >= -e.radial_width)
                inside_phys_near = r <= 0
            else:
                in_ann = (r >= 0) & (r <= e.radial_width)
                inside_phys_near = r >= 0
            # physical classification: near points by r sign; far points by
            # parity (even-odd test) or inherited from the seed partition
            if seed is not None:
                this_phys = seed.per_phys[i_e].copy()
            else:
                inside = points_inside_curve(e.bdy, x, y)
                this_phys = (inside if e.interior else ~inside)
            this_phys[idx] = inside_phys_near
            phys &= this_phys
            self.near_masks.append(near)
            self.per_phys.append(this_phys)
            z2 = idx[in_ann]
            in_annulus[z2] = True
            theta = e.nufft_theta(r[in_ann])
            self.zone2.append((z2, theta, t[in_ann]))
            z3_local = idx[~inside_phys_near]
            self.zone3.append((z3_local, t[~inside_phys_near],
                               r[~inside_phys_near]))
            ft = guess_t.copy()
            fr = np.zeros(n)
            ft[idx] = t
            fr[idx] = r
            self.full_t.append(ft)
            self.full_r.append(fr)
        self.phys = phys
        self.zone1 = np.flatnonzero(phys & ~in_annulus)
        self.zone1_or_2 = phys
        self.n_ext = int((~phys).sum())
        self.pad_quantum = pad_quantum

        def _padded(idx, coords):
            if not pad_quantum:
                return idx, coords
            return pad_index_set(idx, coords, pad_quantum, n)

        g = ebdyc.grid
        dev = ebdyc.device
        z1_idx, (tx1, ty1) = _padded(
            self.zone1, list(ebdyc.transf(x[self.zone1], y[self.zone1])))
        self.grid_plan = PeriodicInterpolator2D(g.Nx, g.Ny, tx1, ty1,
                                                device=dev)
        self.radial_plans = []
        self.zone2_dev = []
        for e, (z2, theta, t) in zip(ebdyc, self.zone2):
            z2_idx, (theta_p, t_p) = _padded(z2, [theta, t])
            self.radial_plans.append(
                make_interpolator(2 * e.M, e.bdy.N, theta_p, t_p,
                                  x_offset=np.pi / (2 * e.M), device=dev))
            self.zone2_dev.append(torch.as_tensor(z2_idx, device=dev))
        self.zone1_dev = torch.as_tensor(z1_idx, device=dev)

    def interpolate(self, ef: EmbeddedFunction,
                    exterior_value=float("nan")) -> torch.Tensor:
        """Interpolate an EmbeddedFunction to the partitioned points: (n,)."""
        return self.interpolate_many([ef], exterior_value)[0]

    def interpolate_many(self, efs, exterior_value=float("nan")):
        """Interpolate B EmbeddedFunctions to the partitioned points in ONE
        batched pass per plan: (B, n).  The semi-Lagrangian departure solve
        needs six fields (u, v and their four gradients) at the same
        points; batched they ride one fine transform (reference analogue:
        the stacked NUFFT of multi_boundary/scalar.py:80-88)."""
        ebdyc = self.ebdyc
        out = torch.full((len(efs), self.x.size), float(exterior_value),
                         dtype=torch.float64, device=ebdyc.device)
        smoothed = torch.stack([ef.grid * ebdyc.grid_step_dev for ef in efs])
        out = set_flat(out, self.zone1_dev, self.grid_plan(smoothed))
        for i_e, (plan, idx) in enumerate(zip(self.radial_plans,
                                              self.zone2_dev)):
            refl = torch.stack([torch.cat([ef.radials[i_e],
                                           ef.radials[i_e].flip(0)], dim=0)
                                for ef in efs])
            out = set_flat(out, idx, plan(refl))
        return out


def interpolate_to_points(ebdyc, ef: EmbeddedFunction, x, y,
                          fix_r: bool = False) -> torch.Tensor:
    """One-shot helper (reference: ebdyc.interpolate_to_points,
    ipde/ebdy_collection.py:666-707)."""
    p = PointPartition(ebdyc, x, y, fix_r=fix_r)
    return p.interpolate(ef)
