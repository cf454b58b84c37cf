"""Poisson, lap u = f in the domain, u = g on the boundary (the equation of
``ipde_tpu_torch.solvers.scalar.PoissonSolver`` with ``DirichletBIE``).

u = sum_j A_j cos(k_j . x + phi_j), so f = -sum_j |k_j|^2 A_j cos(...) and
g = u on the boundary."""

import numpy as np

FORCING = 1
BOUNDARY = 1
FIELDS = ("u",)
MEAN_FREE = ()
CHECKS = {"u_err": ("u",)}


def draw(rng, spec):
    waves = []
    for k in spec["k"]:
        ang, phi = rng.uniform(0.0, 2.0 * np.pi, 2)
        sign = 1.0 if rng.random() < 0.5 else -1.0
        waves.append((float(k * np.cos(ang)), float(k * np.sin(ang)),
                      float(phi), sign / len(spec["k"])))
    return {"waves": waves}


def _sum(p, x, y, xp, term):
    out = 0.0 * x
    for kx, ky, phi, a in p["waves"]:
        out = out + term(kx, ky, a) * xp.cos(kx * x + ky * y + phi)
    return out


def forcing(p, x, y, xp):
    return (_sum(p, x, y, xp, lambda kx, ky, a: -(kx * kx + ky * ky) * a),)


def boundary(p, x, y, xp):
    return (_sum(p, x, y, xp, lambda kx, ky, a: a),)


def exact(p, x, y, dtype=np.float64):
    x = np.asarray(x, dtype)
    y = np.asarray(y, dtype)
    out = np.zeros(x.shape, dtype)
    for kx, ky, phi, a in p["waves"]:
        kx, ky, phi, a = (dtype(v) for v in (kx, ky, phi, a))
        out += a * np.cos(kx * x + ky * y + phi)
    return {"u": out}
