"""The configuration's geometry by closed forms, in plain NumPy.

The boundary is ``star``: c(t) = (x0 + i y0) + rho(t) e^{it}, rho(t) =
r (1 + a cos(f (t - rot))), sampled at N equispaced t, its speed, normal
and curvature by spectral differentiation of the samples.  From it, as
the configuration's sizing rule states:

* h = min(min_t |c'(t)| 2 pi / N, curvature_factor / max |kappa| / M),
  and with ``grid_target`` also min(h, (max x - min x) / (grid_target -
  3 M)) (``bench.py``'s sizing of the Stokes tiers);
* the box: one radial width w = M h to the left and below the curve, two to
  the right and above, each side a multiple of 32 points of spacing h;
* the radial grid: M first-kind Chebyshev nodes on [-w, 0] along the
  outward normal (rows ascending in r);
* the physical grid points: those strictly inside the curve, which is
  star-shaped about (x0, y0), so a point at polar (R, phi) about the centre
  is inside when R < rho(phi).

A moved boundary (``rot``) keeps h and the box of the set-up geometry."""

import numpy as np


def curve(b, rot=0.0):
    """(x, y, normal_x, normal_y, speed, curvature) of the boundary ``b``
    (the configuration's ``boundary``) turned by ``rot``.  The samples are
    the closed form; their derivatives are spectral (the FFT of the
    samples), as the source's sizing rule measures the sampled curve."""
    if b["curve"] != "star":
        raise ValueError(f"no closed form for curve {b['curve']!r}")
    n, r, a, f = b["N"], b["r"], b["a"], b["f"]
    t = np.arange(n) * 2.0 * np.pi / n
    c = (b["x"] + 1j * b["y"]) + r * (1.0 + a * np.cos(f * (t - rot))) \
        * np.exp(1j * t)
    ik = 1j * np.fft.fftfreq(n, 1.0 / n)
    x, y = c.real, c.imag
    xh, yh = np.fft.fft(x), np.fft.fft(y)
    xp, yp = np.fft.ifft(xh * ik).real, np.fft.ifft(yh * ik).real
    xpp, ypp = np.fft.ifft(xh * ik * ik).real, np.fft.ifft(yh * ik * ik).real
    speed = np.hypot(xp, yp)
    kappa = (xp * ypp - yp * xpp) / speed ** 3
    return x, y, yp / speed, -xp / speed, speed, kappa


def spacing(cfg):
    """h of the set-up geometry by the configuration's ``sizing``."""
    b, s, m = cfg["boundary"], cfg["sizing"], cfg["M"]
    x, _, _, _, speed, kappa = curve(b)
    h = min(float((speed * 2.0 * np.pi / b["N"]).min()),
            s["curvature_factor"] / float(np.abs(kappa).max()) / m)
    if s.get("grid_target"):
        h = min(h, float(x.max() - x.min()) / (s["grid_target"] - 3 * m))
    return h


def box(cfg, h):
    """(xv, yv): the grid's coordinate vectors."""
    x, y = curve(cfg["boundary"])[:2]
    w = cfg["M"] * h
    x0, y0 = x.min() - w, y.min() - w
    nx = int(32 * np.ceil((x.max() + 2 * w - x0) / h / 32))
    ny = int(32 * np.ceil((y.max() + 2 * w - y0) / h / 32))
    return (x0 + np.arange(nx) * (((x0 + nx * h) - x0) / nx),
            y0 + np.arange(ny) * (((y0 + ny * h) - y0) / ny))


def inside(cfg, rot, X, Y):
    """Mask of the points (X, Y) strictly inside the boundary turned by
    ``rot``."""
    b = cfg["boundary"]
    dx, dy = X - b["x"], Y - b["y"]
    phi = np.arctan2(dy, dx)
    rho = b["r"] * (1.0 + b["a"] * np.cos(b["f"] * (phi - rot)))
    return np.hypot(dx, dy) < rho


def radial(cfg, h, rot=0.0):
    """(x, y), each (M, N): the radial grid of the boundary turned by
    ``rot``."""
    m = cfg["M"]
    x, y, nx, ny = curve(cfg["boundary"], rot)[:4]
    w = m * h
    r = (-np.cos(np.pi * (np.arange(m) + 0.5) / m) + 1.0) * (w / 2.0) - w
    return x + r[:, None] * nx, y + r[:, None] * ny


class Geometry:
    """Everything ``compare.py`` needs of one boundary position."""

    def __init__(self, cfg, rot=0.0):
        self.h = spacing(cfg)
        xv, yv = box(cfg, self.h)
        self.X, self.Y = np.meshgrid(xv, yv, indexing="ij")
        self.phys = inside(cfg, rot, self.X, self.Y)
        self.rx, self.ry = radial(cfg, self.h, rot)
