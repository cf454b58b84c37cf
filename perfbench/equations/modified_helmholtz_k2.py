"""Modified Helmholtz (Yukawa) at kappa = 2, (kappa^2 - lap) u = f in the
domain, u = g on the boundary (the equation of
``ipde_tpu_torch.solvers.scalar.ModifiedHelmholtzSolver(k=2)`` with
``DirichletBIE``, in its sign convention: ``f`` is the right-hand side of
(k^2 - lap) u = f).

u is Poisson's manufactured solution, sum_j A_j cos(k_j . x + phi_j), drawn
and evaluated by ``poisson.py``; so f = sum_j (kappa^2 + |k_j|^2) A_j
cos(...) and g = u on the boundary.  The harness hands an equation file no
configuration, so kappa is fixed here; the configuration's
``solver_kw["k"]`` states the same number."""

from pathlib import Path

from perfbench.harness.spec import load_module

_poisson = load_module(Path(__file__).with_name("poisson.py"), "equation")

FORCING = 1
BOUNDARY = 1
FIELDS = ("u",)
MEAN_FREE = ()
CHECKS = {"u_err": ("u",)}
KAPPA = 2.0

draw, boundary, exact = _poisson.draw, _poisson.boundary, _poisson.exact


def forcing(p, x, y, xp):
    return (_poisson._sum(
        p, x, y, xp,
        lambda kx, ky, a: (KAPPA * KAPPA + kx * kx + ky * ky) * a),)
