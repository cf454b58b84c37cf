"""Stokes, -lap u + grad p = f and div u = 0 in the domain, u = g on the
boundary (``ipde_tpu_torch.solvers.vector.StokesSolver`` with
``StokesDirichletBIE``; mu = 1).

The velocity comes from a stream function psi = sum_j B_j cos(th_j),
th_j = k_j . x + phi_j: u = psi_y = -sum_j B_j k_jy sin(th_j), v = -psi_x =
sum_j B_j k_jx sin(th_j), so div u = 0 and -lap u = |k_j|^2 u per wave.  The
pressure is p = sum_j C_j cos(q_j . x + chi_j), defined up to a constant."""

import numpy as np

FORCING = 2
BOUNDARY = 2
FIELDS = ("u", "v", "p")
MEAN_FREE = ("p",)
CHECKS = {"uv_err": ("u", "v"), "p_err": ("p",)}


def _waves(rng, ks):
    out = []
    for k in ks:
        ang, phi = rng.uniform(0.0, 2.0 * np.pi, 2)
        sign = 1.0 if rng.random() < 0.5 else -1.0
        out.append((float(k * np.cos(ang)), float(k * np.sin(ang)),
                    float(phi), sign / (len(ks) * k)))
    return out


def draw(rng, spec):
    return {"psi": _waves(rng, spec["k"]), "p": _waves(rng, spec["k"])}


def _velocity(p, x, y, xp, scale):
    u = 0.0 * x
    v = 0.0 * x
    for kx, ky, phi, b in p["psi"]:
        s = xp.sin(kx * x + ky * y + phi) * (b * scale(kx, ky))
        u = u - ky * s
        v = v + kx * s
    return u, v


def forcing(p, x, y, xp):
    fu, fv = _velocity(p, x, y, xp, lambda kx, ky: kx * kx + ky * ky)
    for qx, qy, chi, c in p["p"]:
        s = xp.sin(qx * x + qy * y + chi) * c
        fu = fu - qx * s
        fv = fv - qy * s
    return fu, fv


def boundary(p, x, y, xp):
    return _velocity(p, x, y, xp, lambda kx, ky: 1.0)


def exact(p, x, y, dtype=np.float64):
    x = np.asarray(x, dtype)
    y = np.asarray(y, dtype)
    u = np.zeros(x.shape, dtype)
    v = np.zeros(x.shape, dtype)
    pr = np.zeros(x.shape, dtype)
    for kx, ky, phi, b in p["psi"]:
        kx, ky, phi, b = (dtype(w) for w in (kx, ky, phi, b))
        s = b * np.sin(kx * x + ky * y + phi)
        u -= ky * s
        v += kx * s
    for qx, qy, chi, c in p["p"]:
        qx, qy, chi, c = (dtype(w) for w in (qx, qy, chi, c))
        pr += c * np.cos(qx * x + qy * y + chi)
    return {"u": u, "v": v, "p": pr}
