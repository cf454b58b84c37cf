"""Zone-3 departure-point Newton solves of the semi-Lagrangian advectors, as
plain torch on the collection's device (ipde_tpu.advection.zone3_device).

The advectors' zone-3 points (newly uncovered by the moving boundary;
reference: ipde/advection/fe_advector.py:107-171 and
second_order_advector.py:172-325) need per-point Newton iterations on
boundary-fitted coordinates whose residual evaluates periodic boundary
fields at arbitrary parameters.  The fields are carried as real
half-spectrum coefficient tables (K, F) and evaluated for all P points and
all F fields with the two phase matrices cos(s k), sin(s k) of each
iteration; the iterations are a fixed number of masked updates (a point
stops moving once its residual is below 1e-12), batched over the points,
with one host read of the final residual.  The second-order 4x4 Newton
update uses the closed-form 2x2-block Schur solve of ipde_tpu.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ipde_tpu_torch.config import require_cuda

_TOL = 1e-12


def half_spectrum(fields: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(F, nb) real periodic nodal data -> (K, F) cosine/sine coefficient
    tables with the 2/nb scaling folded in:
        v_f(s) = sum_k Cr[k, f] cos(k s) - Ci[k, f] sin(k s).
    """
    F, nb = fields.shape
    vh = np.fft.rfft(fields, axis=1) / nb          # (F, K)
    vh[:, 1:] *= 2.0
    if nb % 2 == 0:
        vh[:, -1] *= 0.5
    return np.ascontiguousarray(vh.real.T), np.ascontiguousarray(vh.imag.T)


def _eval_all(s, Cr, Ci, kvec):
    """Values and s-derivatives (P, F) of every field at every point s."""
    ang = s[:, None] * kvec[None, :]
    cos_m, sin_m = torch.cos(ang), torch.sin(ang)
    vals = cos_m @ Cr - sin_m @ Ci
    ders = -(sin_m @ (kvec[:, None] * Cr)) - cos_m @ (kvec[:, None] * Ci)
    return vals, ders


# field order for the FE solve
_FE_FIELDS = ("bx", "by", "nx", "ny", "ub", "vb", "urb", "vrb")


def _fe_residual(V, r, dt, xo, yo):
    bx, by, nx, ny, ub, vb, urb, vrb = V.unbind(1)
    f1 = bx + r * nx + dt * (ub + r * urb) - xo
    f2 = by + r * ny + dt * (vb + r * vrb) - yo
    return f1, f2


def _newton_fe(Cr, Ci, kvec, dt, xo, yo, s, r, iters):
    for _ in range(iters):
        V, D = _eval_all(s, Cr, Ci, kvec)
        f1, f2 = _fe_residual(V, r, dt, xo, yo)
        res = torch.hypot(f1, f2)
        _, _, nx, ny, _, _, urb, vrb = V.unbind(1)
        dbx, dby, dnx, dny, dub, dvb, durb, dvrb = D.unbind(1)
        j11 = dbx + r * dnx + dt * (dub + r * durb)
        j21 = dby + r * dny + dt * (dvb + r * dvrb)
        j12 = nx + dt * urb
        j22 = ny + dt * vrb
        det = j11 * j22 - j12 * j21
        det = torch.where(det.abs() < 1e-300, 1.0, det)
        ds = (j22 * f1 - j12 * f2) / det
        dr = (j11 * f2 - j21 * f1) / det
        act = res > _TOL
        s = torch.where(act, s - ds, s)
        r = torch.where(act, r - dr, r)
    # final residual for the host-side convergence check
    V, _ = _eval_all(s, Cr, Ci, kvec)
    f1, f2 = _fe_residual(V, r, dt, xo, yo)
    return s, r, torch.hypot(f1, f2)


def _device(device):
    return require_cuda() if device is None else torch.device(device)


def zone3_newton_fe(fields: Dict[str, np.ndarray], dt: float,
                    xo: np.ndarray, yo: np.ndarray,
                    s0: np.ndarray, r0: np.ndarray, iters: int = 40, *,
                    device=None):
    """FE zone-3 Newton on ``device`` (None: the CUDA card).  fields: the 8
    periodic boundary fields (host numpy); returns host (s, r, max
    residual)."""
    dev = _device(device)
    Cr, Ci = half_spectrum(np.stack([fields[k] for k in _FE_FIELDS]))
    kvec = np.arange(Cr.shape[0], dtype=np.float64)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                  device=dev)
    s, r, res = _newton_fe(t(Cr), t(Ci), t(kvec), dt, t(xo), t(yo), t(s0),
                           t(r0), iters)
    resm = float(res.max()) if res.numel() else 0.0
    return s.cpu().numpy(), r.cpu().numpy(), resm


# field order for the second-order solve (current level & old level)
_SO_FIELDS = ("bx", "by", "nx", "ny", "ub", "vb", "urb", "vrb",
              "urrb", "vrrb")


def _so_residual(Fd, Od, r, ro, dt, xo, yo):
    tay_u = Fd["ub"] + r * Fd["urb"] + 0.5 * r**2 * Fd["urrb"]
    tay_v = Fd["vb"] + r * Fd["vrb"] + 0.5 * r**2 * Fd["vrrb"]
    otay_u = Od["ub"] + ro * Od["urb"] + 0.5 * ro**2 * Od["urrb"]
    otay_v = Od["vb"] + ro * Od["vrb"] + 0.5 * ro**2 * Od["vrrb"]
    f0 = Od["bx"] + ro * Od["nx"] + 2 * dt * tay_u - xo
    f1 = Od["by"] + ro * Od["ny"] + 2 * dt * tay_v - yo
    f2 = Fd["bx"] + r * Fd["nx"] + 1.5 * dt * tay_u - 0.5 * dt * otay_u - xo
    f3 = Fd["by"] + r * Fd["ny"] + 1.5 * dt * tay_v - 0.5 * dt * otay_v - yo
    return f0, f1, f2, f3


def _solve4_block(J, b0, b1, b2, b3):
    """Solve the (P, 4, 4) systems via 2x2-block Schur complement with
    closed-form 2x2 inverses.  J given as dict of entries J[(i, j)] ->
    (P,)."""
    def inv2(a, b, c, d):
        det = a * d - b * c
        det = torch.where(det.abs() < 1e-300, 1e-300, det)
        return d / det, -b / det, -c / det, a / det

    A = (J[(0, 0)], J[(0, 1)], J[(1, 0)], J[(1, 1)])
    B = (J[(0, 2)], J[(0, 3)], J[(1, 2)], J[(1, 3)])
    C = (J[(2, 0)], J[(2, 1)], J[(3, 0)], J[(3, 1)])
    D = (J[(2, 2)], J[(2, 3)], J[(3, 2)], J[(3, 3)])
    ia, ib, ic, id_ = inv2(*A)
    # S = D - C A^-1 B
    ca = C[0] * ia + C[1] * ic
    cb = C[0] * ib + C[1] * id_
    cc = C[2] * ia + C[3] * ic
    cd = C[2] * ib + C[3] * id_
    s00 = D[0] - (ca * B[0] + cb * B[2])
    s01 = D[1] - (ca * B[1] + cb * B[3])
    s10 = D[2] - (cc * B[0] + cd * B[2])
    s11 = D[3] - (cc * B[1] + cd * B[3])
    isa, isb, isc, isd = inv2(s00, s01, s10, s11)
    # y2 = S^-1 (b2' - C A^-1 b01)
    a0 = ia * b0 + ib * b1
    a1 = ic * b0 + id_ * b1
    r2 = b2 - (C[0] * a0 + C[1] * a1)
    r3 = b3 - (C[2] * a0 + C[3] * a1)
    y2 = isa * r2 + isb * r3
    y3 = isc * r2 + isd * r3
    # y0 = A^-1 (b01 - B y23)
    q0 = b0 - (B[0] * y2 + B[1] * y3)
    q1 = b1 - (B[2] * y2 + B[3] * y3)
    y0 = ia * q0 + ib * q1
    y1 = ic * q0 + id_ * q1
    return y0, y1, y2, y3


def _fields_at(Crt, Cit, kvec, s):
    V, D = _eval_all(s, Crt, Cit, kvec)
    return ({k: V[:, i] for i, k in enumerate(_SO_FIELDS)},
            {k: D[:, i] for i, k in enumerate(_SO_FIELDS)})


def _so_max(fs):
    f0, f1, f2, f3 = (f.abs() for f in fs)
    return torch.maximum(torch.maximum(f0, f1), torch.maximum(f2, f3))


def _newton_so(Cr, Ci, Cro, Cio, kvec, dt, xo, yo, s, r, so, ro, iters):
    for _ in range(iters):
        Fd, Dd = _fields_at(Cr, Ci, kvec, s)
        Od, Do = _fields_at(Cro, Cio, kvec, so)
        fs = _so_residual(Fd, Od, r, ro, dt, xo, yo)
        res = _so_max(fs)
        tay_us = Dd["ub"] + r * Dd["urb"] + 0.5 * r**2 * Dd["urrb"]
        tay_vs = Dd["vb"] + r * Dd["vrb"] + 0.5 * r**2 * Dd["vrrb"]
        otay_us = Do["ub"] + ro * Do["urb"] + 0.5 * ro**2 * Do["urrb"]
        otay_vs = Do["vb"] + ro * Do["vrb"] + 0.5 * ro**2 * Do["vrrb"]
        tay_ur = Fd["urb"] + r * Fd["urrb"]
        tay_vr = Fd["vrb"] + r * Fd["vrrb"]
        otay_ur = Od["urb"] + ro * Od["urrb"]
        otay_vr = Od["vrb"] + ro * Od["vrrb"]
        J = {
            (0, 0): 2 * dt * tay_us,
            (1, 0): 2 * dt * tay_vs,
            (2, 0): Dd["bx"] + r * Dd["nx"] + 1.5 * dt * tay_us,
            (3, 0): Dd["by"] + r * Dd["ny"] + 1.5 * dt * tay_vs,
            (0, 1): 2 * dt * tay_ur,
            (1, 1): 2 * dt * tay_vr,
            (2, 1): Fd["nx"] + 1.5 * dt * tay_ur,
            (3, 1): Fd["ny"] + 1.5 * dt * tay_vr,
            (0, 2): Do["bx"] + ro * Do["nx"],
            (1, 2): Do["by"] + ro * Do["ny"],
            (2, 2): -0.5 * dt * otay_us,
            (3, 2): -0.5 * dt * otay_vs,
            (0, 3): Od["nx"],
            (1, 3): Od["ny"],
            (2, 3): -0.5 * dt * otay_ur,
            (3, 3): -0.5 * dt * otay_vr,
        }
        # unknown order matches the host loop: (s, r, so, ro)
        ds, dr, dso, dro = _solve4_block(J, *fs)
        act = res > _TOL
        s = torch.where(act, s - ds, s)
        r = torch.where(act, r - dr, r)
        so = torch.where(act, so - dso, so)
        ro = torch.where(act, ro - dro, ro)
    Fd, _ = _fields_at(Cr, Ci, kvec, s)
    Od, _ = _fields_at(Cro, Cio, kvec, so)
    return s, r, so, ro, _so_max(_so_residual(Fd, Od, r, ro, dt, xo, yo))


def zone3_newton_so(fields: Dict[str, np.ndarray],
                    old_fields: Dict[str, np.ndarray], dt: float,
                    xo, yo, s0, r0, so0, ro0, iters: int = 60, *,
                    device=None):
    """Second-order zone-3 Newton on ``device`` (None: the CUDA card);
    returns host (s, r, so, ro, max residual)."""
    dev = _device(device)
    Cr, Ci = half_spectrum(np.stack([fields[k] for k in _SO_FIELDS]))
    Cro, Cio = half_spectrum(np.stack([old_fields[k] for k in _SO_FIELDS]))
    # the two levels may have different nb; pad spectra to a common K
    K = max(Cr.shape[0], Cro.shape[0])
    padK = lambda C: np.pad(C, ((0, K - C.shape[0]), (0, 0)))  # noqa: E731
    kvec = np.arange(K, dtype=np.float64)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                  device=dev)
    s, r, so, ro, res = _newton_so(
        t(padK(Cr)), t(padK(Ci)), t(padK(Cro)), t(padK(Cio)), t(kvec), dt,
        t(xo), t(yo), t(s0), t(r0), t(so0), t(ro0), iters)
    host = lambda a: a.cpu().numpy()  # noqa: E731
    return (host(s), host(r), host(so), host(ro),
            float(res.max()) if res.numel() else 0.0)
