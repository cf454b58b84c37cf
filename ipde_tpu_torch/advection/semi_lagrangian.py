"""Semi-Lagrangian advection with moving boundaries
(ipde_tpu.advection.semi_lagrangian, on torch).

First-order (forward Euler) advector; reference:
ipde/advection/fe_advector.py:9-197.  Each step:
  1. move each boundary with its own interpolated velocity, arc-length
     reparametrize, regenerate the embedded geometry + grid registration,
  2. find departure points for every new grid/radial point:
       zones 1-2 (old-physical): linearized backtrace,
       (I + dt grad(u)) d = dt u(x)  ->  x_d = x - d,
     zone 3 (newly uncovered points, outside the OLD domain): batched
     Newton on boundary-fitted coordinates (s, r) of the departure point
     using the boundary-velocity Taylor model
       c_old(s) + r n_old(s) + dt [u_b(s) + r du/dn(s)] = x_new,
  3. advect: f_new(x) = f_old(x_d) by zonewise spectral interpolation.

The geometry and the departure points are host numpy, as in ipde_tpu; the
interpolations, the gradients and the zone-3 Newton solves run on the
collection's device.  The stationary-boundary and prescribed-boundary
variants of the reference (fe_advector_stationary_bdy.py,
fe_advector_given_bdy.py) are the ``fixed_boundary`` and
``boundary_motion`` options here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import torch

from ipde_tpu_torch.advection.zone3_device import (zone3_newton_fe,
                                                   zone3_newton_so)
from ipde_tpu_torch.functions import EmbeddedFunction
from ipde_tpu_torch.geometry.collection import (EmbeddedBoundaryCollection,
                                                set_flat)
from ipde_tpu_torch.geometry.curve import arc_length_parameterize
from ipde_tpu_torch.geometry.partition import PointPartition


def _trig_interp(vals: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spectral evaluation of periodic nodal data at parameters t."""
    n = vals.size
    vh = np.fft.fft(vals)
    k = np.fft.fftfreq(n, 1.0 / n)
    ph = np.exp(1j * np.outer(t, k))
    return (ph @ vh).real / n


def _trig_deriv(vals: np.ndarray) -> np.ndarray:
    n = vals.size
    k = np.fft.fftfreq(n, 1.0 / n)
    return np.fft.ifft(np.fft.fft(vals) * 1j * k).real


def _host(a) -> np.ndarray:
    return a.cpu().numpy()


def _boundary_values(ebdyc, f: EmbeddedFunction):
    """Host (N_b,) boundary values of each boundary's radial part of f."""
    return [e.interpolate_radial_to_boundary(_host(fr))
            for e, fr in zip(ebdyc, f.radials)]


def _umax(u: EmbeddedFunction, v: EmbeddedFunction) -> float:
    return float(np.sqrt(float(abs(u * u + v * v).max())))


def _query_points(ebdyc):
    """The points that need values on a geometry: its (padded) pna grid
    points, then every radial point."""
    px = np.concatenate([ebdyc.pna_x] + [e.radial_x.ravel() for e in ebdyc])
    py = np.concatenate([ebdyc.pna_y] + [e.radial_y.ravel() for e in ebdyc])
    return px, py


def _assemble(new_ebdyc, vals: torch.Tensor) -> EmbeddedFunction:
    """EmbeddedFunction on new_ebdyc from values at its _query_points: the
    pna values are scattered onto the grid (padded slots dropped), the
    radial values reshaped, then merged onto the grid.  The query points
    hold the host pna set, the first slots of ``pna_flat_dev``'s
    capacity."""
    n_pna = new_ebdyc.pna_x.size
    grid = set_flat(torch.zeros(new_ebdyc.grid.Nx * new_ebdyc.grid.Ny,
                                dtype=vals.dtype, device=vals.device),
                    new_ebdyc.pna_flat_dev[:n_pna], vals[:n_pna])\
        .reshape(new_ebdyc.grid.shape)
    radials = []
    start = n_pna
    for e in new_ebdyc:
        cnt = int(np.prod(e.radial_shape))
        radials.append(vals[start:start + cnt].reshape(e.radial_shape))
        start += cnt
    grid = new_ebdyc.interpolate_radial_to_grid(radials, grid)
    return EmbeddedFunction(grid * new_ebdyc.phys_dev, radials)


class SemiLagrangianAdvector:
    """First-order (FE) semi-Lagrangian advector."""

    def __init__(self, ebdyc: EmbeddedBoundaryCollection, u: EmbeddedFunction,
                 v: EmbeddedFunction, filter_fraction: float = 0.9):
        self.ebdyc = ebdyc
        self.u = u
        self.v = v
        self.ux, self.uy = ebdyc.gradient(u)
        self.vx, self.vy = ebdyc.gradient(v)
        self.filter_fraction = filter_fraction
        self.new_ebdyc = None

    def generate(self, dt: float, fixed_grid: bool = False,
                 fixed_boundary: bool = False,
                 boundary_motion: Optional[Callable] = None):
        """Move boundaries, rebuild geometry, compute departure points."""
        ebdyc = self.ebdyc
        # boundary velocities
        ubs = _boundary_values(ebdyc, self.u)
        vbs = _boundary_values(ebdyc, self.v)
        new_ebdys = []
        self.reparmed_ubs = []
        self.reparmed_vbs = []
        for e, ub, vb in zip(ebdyc, ubs, vbs):
            if fixed_boundary:
                new_ebdys.append(e)
                self.reparmed_ubs.append(ub)
                self.reparmed_vbs.append(vb)
                continue
            if boundary_motion is not None:
                bx, by = boundary_motion(e.bdy.x, e.bdy.y, dt)
            else:
                bx = e.bdy.x + dt * ub
                by = e.bdy.y + dt * vb
            crv, new_t = arc_length_parameterize(bx, by, return_t=True)
            # velocity samples at the new parametrization (used by the
            # second-order advector's AB2 boundary update)
            self.reparmed_ubs.append(_trig_interp(ub, new_t))
            self.reparmed_vbs.append(_trig_interp(vb, new_t))
            new_ebdys.append(e.regenerate(crv.x, crv.y))
        new_ebdyc = EmbeddedBoundaryCollection(new_ebdys,
                                               device=ebdyc.device)
        umax = _umax(self.u, self.v)
        ddd = 2.0 * umax * dt
        if ddd > new_ebdyc.ebdys[0].radial_width:
            raise ValueError("timestep oversteps the annulus safety zone; "
                             "reduce dt")
        pq = getattr(ebdyc, "pad_quantum", None)
        if fixed_grid or fixed_boundary:
            new_ebdyc.register_grid(ebdyc.grid, danger_zone_distance=ddd,
                                    pad_quantum=pq)
        else:
            new_ebdyc.generate_grid(h=ebdyc.ebdys[0].h,
                                    danger_zone_distance=ddd,
                                    pad_quantum=pq)

        # points needing values: new pna grid points + new radial points
        # (pna is capacity-padded under pad_quantum, so this point set --
        # and every plan built on it -- keeps a step-invariant shape)
        px, py = _query_points(new_ebdyc)
        # capture band widened by ddd so `part` can seed the departure-point
        # partition below (departure displacement <= umax dt = ddd/2)
        part = PointPartition(ebdyc, px, py, extra_capture=ddd,
                              pad_quantum=pq)
        # zones 1-2: linearized departure solve (u, v + 4 gradients in ONE
        # batched interpolation pass)
        six = _host(part.interpolate_many(
            [self.u, self.v, self.ux, self.uy, self.vx, self.vy]))
        uh, vh, uxh, uyh, vxh, vyh = six
        sel = part.zone1_or_2
        det = (1 + dt * uxh[sel]) * (1 + dt * vyh[sel]) \
            - dt * uyh[sel] * dt * vxh[sel]
        dx = ((1 + dt * vyh[sel]) * dt * uh[sel]
              - dt * uyh[sel] * dt * vh[sel]) / det
        dy = ((1 + dt * uxh[sel]) * dt * vh[sel]
              - dt * vxh[sel] * dt * uh[sel]) / det
        xd = px.copy()
        yd = py.copy()
        xd[sel] = px[sel] - dx
        yd[sel] = py[sel] - dy
        # zone 3: newly uncovered points -- Newton on boundary coordinates
        for ind, (e, ub, vb) in enumerate(zip(ebdyc, ubs, vbs)):
            z3, s0, r0 = part.zone3[ind]
            if z3.size == 0:
                continue
            urb = e.interpolate_radial_to_boundary_normal_derivative(
                _host(self.u.radials[ind]))
            vrb = e.interpolate_radial_to_boundary_normal_derivative(
                _host(self.v.radials[ind]))
            b = e.bdy
            fields = dict(bx=b.x, by=b.y, nx=b.normal_x, ny=b.normal_y,
                          ub=ub, vb=vb, urb=urb, vrb=vrb)
            xo, yo = px[z3], py[z3]
            # fixed-iteration masked Newton on the device
            s, r, res = zone3_newton_fe(fields, dt, xo, yo, s0, r0,
                                        device=ebdyc.device)
            if res > 1e-8:
                raise RuntimeError(
                    "FE advector zone-3 Newton failed to converge "
                    f"(boundary {ind}, residual {res:.2e}); reduce dt")
            # clamp coordinates that left the physical side (reference
            # 'fail' handling: second_order_advector.py:295-315)
            lo, hi = (-e.radial_width, 0.0) if e.interior \
                else (0.0, e.radial_width)
            r = np.clip(r, lo, hi)
            F = {k: _trig_interp(v_, s) for k, v_ in fields.items()}
            xd[z3] = F["bx"] + F["nx"] * r
            yd[z3] = F["by"] + F["ny"] * r
        self.new_ebdyc = new_ebdyc
        self.xd = xd
        self.yd = yd
        self.dep_partition = PointPartition(ebdyc, xd, yd, fix_r=True,
                                            seed=part, pad_quantum=pq)
        return new_ebdyc

    def __call__(self, f: EmbeddedFunction) -> EmbeddedFunction:
        """Advect f from the old geometry onto the new one."""
        new_ebdyc = self.new_ebdyc
        vals = self.dep_partition.interpolate(f, exterior_value=0.0)
        return _assemble(new_ebdyc, vals)


# reference-compatible alias
FE_Advector = SemiLagrangianAdvector


class SecondOrderAdvector:
    """Second-order (BDF2/AB2) semi-Lagrangian advector.

    Reference: ipde/advection/second_order_advector.py:9-357.  Uses two time
    levels: the boundary moves with AB2; departure points (x_d at t_n, x_D at
    t_{n-1}) solve the linearized two-level characteristic system in zones
    1-2 and a coupled 4x4 Newton on boundary coordinates (with second-order
    velocity Taylor models) for newly uncovered points.

    __call__(f, fo) returns interp(f at x_d) + interp(fo at x_D): pass the
    BDF2-weighted fields (4/3 f^n, -1/3 f^{n-1}) or use advect_bdf2.
    """

    def __init__(self, ebdyc, u, v, old_advector, filter_fraction=0.9):
        self.ebdyc = ebdyc
        self.u = u
        self.v = v
        self.ebdyc_old = old_advector.ebdyc
        self.uo = old_advector.u
        self.vo = old_advector.v
        self.ubos = list(old_advector.reparmed_ubs)
        self.vbos = list(old_advector.reparmed_vbs)
        self.ux, self.uy = ebdyc.gradient(u)
        self.vx, self.vy = ebdyc.gradient(v)
        self.uxo, self.uyo = old_advector.ux, old_advector.uy
        self.vxo, self.vyo = old_advector.vx, old_advector.vy
        self.filter_fraction = filter_fraction
        self.new_ebdyc = None

    def generate(self, dt: float, fixed_grid: bool = False,
                 fixed_boundary: bool = False,
                 boundary_motion: Optional[Callable] = None):
        """Move boundaries (AB2 by default, external prescription via
        ``boundary_motion``, or none with ``fixed_boundary``) and compute the
        two-level departure points.  Reference variants:
        second_order_advector.py (AB2), second_order_advector_stationary_bdy
        .py (fixed), second_order_advector_given_bdy.py (prescribed)."""
        ebdyc = self.ebdyc
        ebdyc_old = self.ebdyc_old
        ubs = _boundary_values(ebdyc, self.u)
        vbs = _boundary_values(ebdyc, self.v)
        new_ebdys = []
        self.reparmed_ubs = []
        self.reparmed_vbs = []
        for e, ub, vb, ubo, vbo in zip(ebdyc, ubs, vbs, self.ubos, self.vbos):
            if fixed_boundary:
                new_ebdys.append(e)
                self.reparmed_ubs.append(ub)
                self.reparmed_vbs.append(vb)
                continue
            if boundary_motion is not None:
                bx, by = boundary_motion(e.bdy.x, e.bdy.y, dt)
            else:
                bx = e.bdy.x + 0.5 * dt * (3 * ub - ubo)
                by = e.bdy.y + 0.5 * dt * (3 * vb - vbo)
            crv, new_t = arc_length_parameterize(bx, by, return_t=True)
            self.reparmed_ubs.append(_trig_interp(ub, new_t))
            self.reparmed_vbs.append(_trig_interp(vb, new_t))
            new_ebdys.append(e.regenerate(crv.x, crv.y))
        new_ebdyc = EmbeddedBoundaryCollection(new_ebdys,
                                               device=ebdyc.device)
        umax = _umax(self.u, self.v)
        ddd = 2.0 * umax * dt
        if ddd > new_ebdyc.ebdys[0].radial_width:
            raise ValueError("timestep oversteps the annulus safety zone")
        pq = getattr(ebdyc, "pad_quantum", None)
        if fixed_grid or fixed_boundary:
            new_ebdyc.register_grid(ebdyc.grid, danger_zone_distance=ddd,
                                    pad_quantum=pq)
        else:
            new_ebdyc.generate_grid(h=ebdyc.ebdys[0].h,
                                    danger_zone_distance=ddd,
                                    pad_quantum=pq)
        px, py = _query_points(new_ebdyc)
        # capture widened by ddd: these partitions seed the departure-point
        # partitions (displacements: x_d ~ dt u <= ddd/2, x_D ~ 2 dt u <= ddd)
        part = PointPartition(ebdyc, px, py, extra_capture=ddd,
                              pad_quantum=pq)
        part_o = PointPartition(ebdyc_old, px, py, extra_capture=ddd,
                                pad_quantum=pq)
        six = _host(part.interpolate_many(
            [self.u, self.v, self.ux, self.uy, self.vx, self.vy]))
        uh, vh, uxh, uyh, vxh, vyh = six
        sixo = _host(part_o.interpolate_many(
            [self.uo, self.vo, self.uxo, self.uyo, self.vxo, self.vyo]))
        uoh, voh, uxoh, uyoh, vxoh, vyoh = sixo
        sel = part.zone1_or_2 & part_o.zone1_or_2
        ns = int(sel.sum())
        # two-level characteristic system (reference:
        # second_order_advector.py:139-170): unknowns (dx, dy, Dx, Dy)
        SLM = np.zeros((ns, 4, 4))
        SLR = np.zeros((ns, 4))
        SLM[:, 0, 0] = uxh[sel]
        SLM[:, 0, 1] = uyh[sel]
        SLM[:, 0, 2] = 0.5 / dt
        SLM[:, 1, 0] = vxh[sel]
        SLM[:, 1, 1] = vyh[sel]
        SLM[:, 1, 3] = 0.5 / dt
        SLM[:, 2, 0] = 2.0 / dt + 3 * uxh[sel]
        SLM[:, 2, 1] = 3 * uyh[sel]
        SLM[:, 2, 2] = -uxoh[sel]
        SLM[:, 2, 3] = -uyoh[sel]
        SLM[:, 3, 0] = 3 * vxh[sel]
        SLM[:, 3, 1] = 2.0 / dt + 3 * vyh[sel]
        SLM[:, 3, 2] = -vxoh[sel]
        SLM[:, 3, 3] = -vyoh[sel]
        SLR[:, 0] = uh[sel]
        SLR[:, 1] = vh[sel]
        SLR[:, 2] = 3 * uh[sel] - uoh[sel]
        SLR[:, 3] = 3 * vh[sel] - voh[sel]
        OUT = np.linalg.solve(SLM, SLR[..., None])[..., 0]
        xd = px.copy(); yd = py.copy()
        xD = px.copy(); yD = py.copy()
        xd[sel] = px[sel] - OUT[:, 0]
        yd[sel] = py[sel] - OUT[:, 1]
        xD[sel] = px[sel] - OUT[:, 2]
        yD[sel] = py[sel] - OUT[:, 3]
        # zone 3: coupled Newton with 2nd-order boundary Taylor models.
        # Each boundary handles only ITS OWN aphysical points (the union of
        # its zone-3 sets at the two time levels, reference
        # second_order_advector.py fc3l = unique(concat([c3l, oc3l]))) —
        # a global index set would let the last boundary overwrite other
        # boundaries' departure points in multi-body runs.
        if int((~sel).sum()):
            for ind, (e, eo) in enumerate(zip(ebdyc, ebdyc_old)):
                fc3 = np.union1d(part.zone3[ind][0], part_o.zone3[ind][0])
                if fc3.size == 0:
                    continue
                ur = _host(self.u.radials[ind])
                vr = _host(self.v.radials[ind])
                uro = _host(self.uo.radials[ind])
                vro = _host(self.vo.radials[ind])
                dn = e.interp_dn_to_bdy
                dn2 = e.interp_dn2_to_bdy
                dno = eo.interp_dn_to_bdy
                dn2o = eo.interp_dn2_to_bdy
                fields = dict(
                    bx=e.bdy.x, by=e.bdy.y, nx=e.bdy.normal_x,
                    ny=e.bdy.normal_y, ub=ubs[ind], vb=vbs[ind],
                    urb=dn @ ur, vrb=dn @ vr, urrb=dn2 @ ur, vrrb=dn2 @ vr)
                of = dict(
                    bx=eo.bdy.x, by=eo.bdy.y, nx=eo.bdy.normal_x,
                    ny=eo.bdy.normal_y,
                    ub=eo.interpolate_radial_to_boundary(uro),
                    vb=eo.interpolate_radial_to_boundary(vro),
                    urb=dno @ uro, vrb=dno @ vro,
                    urrb=dn2o @ uro, vrrb=dn2o @ vro)
                xo_, yo_ = px[fc3], py[fc3]
                s = part.full_t[ind][fc3].copy()
                r = part.full_r[ind][fc3].copy()
                so = part_o.full_t[ind][fc3].copy()
                ro = part_o.full_r[ind][fc3].copy()
                # fixed-iteration masked Newton on the device
                s, r, so, ro, res = zone3_newton_so(
                    fields, of, dt, xo_, yo_, s, r, so, ro,
                    device=ebdyc.device)
                if res > 1e-8:
                    raise RuntimeError(
                        "second-order zone-3 Newton failed to converge "
                        f"(boundary {ind}, residual {res:.2e}); reduce dt")
                # clamp coordinates that left the physical side
                # (reference 'fail' handling: second_order_advector.py:295-315)
                lo, hi = (-e.radial_width, 0.0) if e.interior \
                    else (0.0, e.radial_width)
                r = np.clip(r, lo, hi)
                ro = np.clip(ro, lo, hi)
                F = {k: _trig_interp(w, s) for k, w in fields.items()}
                O = {k: _trig_interp(w, so) for k, w in of.items()}
                xd[fc3] = F["bx"] + F["nx"] * r
                yd[fc3] = F["by"] + F["ny"] * r
                xD[fc3] = O["bx"] + O["nx"] * ro
                yD[fc3] = O["by"] + O["ny"] * ro
        self.new_ebdyc = new_ebdyc
        self.dep_partition = PointPartition(ebdyc, xd, yd, fix_r=True,
                                            seed=part, pad_quantum=pq)
        self.dep_partition_old = PointPartition(ebdyc_old, xD, yD,
                                                fix_r=True, seed=part_o,
                                                pad_quantum=pq)
        return new_ebdyc

    def __call__(self, f: EmbeddedFunction,
                 fo: EmbeddedFunction) -> EmbeddedFunction:
        new_ebdyc = self.new_ebdyc
        vals = (self.dep_partition.interpolate(f, exterior_value=0.0)
                + self.dep_partition_old.interpolate(fo, exterior_value=0.0))
        return _assemble(new_ebdyc, vals)

    def advect_bdf2(self, f_n: EmbeddedFunction,
                    f_nm1: EmbeddedFunction) -> EmbeddedFunction:
        """BDF2 advection step: f^{n+1} = (4/3) f^n(x_d) - (1/3) f^{n-1}(x_D)."""
        return self((4.0 / 3.0) * f_n, (-1.0 / 3.0) * f_nm1)


class ThirdOrderAdvector:
    """Third-order (BDF3) semi-Lagrangian advector, STATIONARY boundaries.

    Goes beyond the reference's shipped advector family (FE/BDF2); the
    reference's experiment scripts compare FE/AB2/BDF2-4 against fine-dt
    truth (examples/semi_lagrangian_experiments/unsteady_semi_experiment
    .py:28-58) -- this provides the BDF3 member for stationary-boundary
    flows (u . n = 0 on the boundary).

    Departure points X(t_n - k dt), k = 0, 1, 2 integrate the
    characteristic dX/dtau = -u(X, t) backward from the arrival point with
    one classical RK3 step per dt segment; velocity at intermediate times
    is the three-level quadratic Lagrange interpolant in time (levels
    t_n, t_{n-1}, t_{n-2}), extrapolated to t_{n+1} -- the O(dt^3)
    extrapolation error matches the scheme order.

    Chaining mirrors SecondOrderAdvector: pass the previous step's
    SecondOrder/ThirdOrder advector; its (u, v) / (uo, vo) provide the
    t_{n-1} / t_{n-2} velocity levels.

    __call__(f, fm1, fm2) = (18 f(xd1) - 9 fm1(xd2) + 2 fm2(xd3)) / 11.
    """

    def __init__(self, ebdyc, u, v, old_advector, filter_fraction=0.9):
        self.ebdyc = ebdyc
        self.u = u
        self.v = v
        self.uo = old_advector.u
        self.vo = old_advector.v
        self.uoo = old_advector.uo
        self.voo = old_advector.vo
        self.filter_fraction = filter_fraction
        self.new_ebdyc = None
        self.extra_capture = 0.0

    def _uv_at(self, x, y, theta, seed=None):
        """(u, v) at points (x, y) and time t_n - theta dt by quadratic
        Lagrange interpolation through the three stored levels.  The first
        (unseeded) partition captures extra_capture = 3 umax dt beyond the
        annulus band, the farthest the trace goes in ``generate``, so that
        every later partition seeded from it finds each point that enters
        an annulus (ipde_tpu passes 0 here and can misclassify such a point
        as zone 1)."""
        pq = getattr(self.ebdyc, "pad_quantum", None)
        part = PointPartition(self.ebdyc, x, y, fix_r=True, seed=seed,
                              extra_capture=self.extra_capture,
                              pad_quantum=pq)
        six = _host(part.interpolate_many(
            [self.u, self.v, self.uo, self.vo, self.uoo, self.voo],
            exterior_value=0.0))
        w0 = 0.5 * (theta - 1.0) * (theta - 2.0)
        w1 = -theta * (theta - 2.0)
        w2 = 0.5 * theta * (theta - 1.0)
        uu = w0 * six[0] + w1 * six[2] + w2 * six[4]
        vv = w0 * six[1] + w1 * six[3] + w2 * six[5]
        return uu, vv, part

    def generate(self, dt: float, fixed_boundary: bool = True,
                 fixed_grid: bool = True):
        """Compute the three departure-point sets.  Stationary boundaries
        only: the geometry (and so every interpolation plan) is reused."""
        if not fixed_boundary:
            raise NotImplementedError(
                "ThirdOrderAdvector supports stationary boundaries only "
                "(the reference's moving-boundary scripts stop at BDF2)")
        ebdyc = self.ebdyc
        new_ebdyc = ebdyc                      # geometry reused
        umax = _umax(self.u, self.v)
        if 3.0 * umax * dt > ebdyc.ebdys[0].radial_width:
            raise ValueError("timestep oversteps the annulus safety zone "
                             "(BDF3 traces back 3 dt); reduce dt")
        self.extra_capture = 3.0 * umax * dt
        px, py = _query_points(ebdyc)
        # RK3 (Kutta) backward through each dt segment, theta = -1 .. 2
        X, Y = px.copy(), py.copy()
        seed = None
        self.dep_partitions = []
        for k in range(3):
            th = -1.0 + k
            u1, v1, seed = self._uv_at(X, Y, th, seed)
            k1x, k1y = -dt * u1, -dt * v1
            u2, v2, seed = self._uv_at(X + 0.5 * k1x, Y + 0.5 * k1y,
                                       th + 0.5, seed)
            k2x, k2y = -dt * u2, -dt * v2
            u3, v3, seed = self._uv_at(X - k1x + 2 * k2x, Y - k1y + 2 * k2y,
                                       th + 1.0, seed)
            k3x, k3y = -dt * u3, -dt * v3
            X = X + (k1x + 4 * k2x + k3x) / 6.0
            Y = Y + (k1y + 4 * k2y + k3y) / 6.0
            pq = getattr(ebdyc, "pad_quantum", None)
            self.dep_partitions.append(
                PointPartition(ebdyc, X.copy(), Y.copy(), fix_r=True,
                               seed=seed, pad_quantum=pq))
        self.new_ebdyc = new_ebdyc
        return new_ebdyc

    def __call__(self, f: EmbeddedFunction, fm1: EmbeddedFunction,
                 fm2: EmbeddedFunction) -> EmbeddedFunction:
        """BDF3 advection: (18 f(xd1) - 9 fm1(xd2) + 2 fm2(xd3)) / 11."""
        new_ebdyc = self.new_ebdyc
        d1, d2, d3 = self.dep_partitions
        vals = ((18.0 / 11.0) * d1.interpolate(f, exterior_value=0.0)
                + (-9.0 / 11.0) * d2.interpolate(fm1, exterior_value=0.0)
                + (2.0 / 11.0) * d3.interpolate(fm2, exterior_value=0.0))
        return _assemble(new_ebdyc, vals)
