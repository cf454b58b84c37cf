"""Coupled advection-diffusion with a moving boundary on the port
(ipde_tpu_torch, on the card): the counterpart of
examples/coupled_advection_diffusion.py (reference:
examples/semi_lagrangian_experiments/coupled_simplify*.py):
  c_t + u . grad(c) = nu lap(c),  boundary moves with u.
Scheme: FE semi-Lagrangian advection + backward-Euler diffusion,
  (I - dt nu lap) c^{n+1} = c^n(x_d), a modified Helmholtz solve with
  k^2 = 1/(dt nu), through CoupledAdvectionDiffusionStepper (advector,
  ModifiedHelmholtzSolver with helper reuse, NeumannBIE; eager, no
  planify).  Test: rigid rotation (the boundary rotates, its shape kept)
  with a diffusing Gaussian, against the exact rotating-diffusing solution.
Same problem, defaults (ADV_NB, ADV_M, ADV_STEPS) and output as the
reference: per-step generate / advect / setup / solve seconds, the relative
error and the final mass; the row goes into LEDGER_TORCH.json under
"coupled_advection_diffusion@<card>".  GMRES tol 1e-12; see
examples/_torch_common.py for the port's rule.

Usage:
    python examples/torch_coupled_advection_diffusion.py        # on the card
    python examples/torch_coupled_advection_diffusion.py --device cpu
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_common as common  # noqa: E402

NU, DT, T0 = 0.05, 0.05, 0.5


def c_exact(x, y, T):
    """A centered isotropic Gaussian is invariant under the rotation and
    diffuses as c = exp(-r^2 / (4 nu (t + t0))) / (4 pi nu (t + t0))."""
    s = 4 * NU * (T + T0)
    return np.exp(-(x * x + y * y) / s) / (np.pi * s)


def run(nb=200, M=10, steps=4, device=None, verbose=True):
    """``steps`` steps on ``device`` (None: the card); returns (relative
    error, final mass, per-step seconds)."""
    from ipde_tpu_torch.advection.stepper import \
        CoupledAdvectionDiffusionStepper
    from ipde_tpu_torch.functions import EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary

    bdy = star(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
        device=device)
    ebdyc.generate_grid(bh, pad_quantum=2048)
    c = EmbeddedFunction.from_function(ebdyc,
                                       lambda x, y: c_exact(x, y, 0.0))

    def velocity(ec):
        return (EmbeddedFunction.from_function(ec, lambda x, y: -y),
                EmbeddedFunction.from_function(ec, lambda x, y: x))

    stepper = CoupledAdvectionDiffusionStepper(ebdyc, velocity, NU, DT,
                                               tol=1e-12)
    T = 0.0
    t_start = time.perf_counter()
    step_rows = []
    for n in range(steps):
        c = stepper.step(c)
        T += DT
        row = dict(stepper.last_times)
        step_rows.append(row)
        if verbose:
            print(f"step {n + 1}/{steps}: generate {row['generate_s']:.3f}s "
                  f" advect {row['advect_s']:.3f}s  setup "
                  f"{row['setup_s']:.3f}s  solve {row['solve_s']:.3f}s  "
                  f"(total {time.perf_counter() - t_start:.1f}s)", flush=True)
    ebdyc = stepper.ebdyc
    err = common.max_err(ebdyc, c, lambda x, y: c_exact(x, y, T))
    g = ebdyc.grid
    scale = float(c_exact(g.xg, g.yg, T)[ebdyc.phys].max())
    return err / scale, float(ebdyc.volume_integral(c)), step_rows


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    nb = int(os.environ.get("ADV_NB", 200))
    M = int(os.environ.get("ADV_M", 10))
    steps = int(os.environ.get("ADV_STEPS", 4))
    rel_err, mass, step_rows = run(nb, M, steps, device)
    print(f"coupled adv-diff: rel err {rel_err:.10e} after T={steps * DT:g}",
          flush=True)
    print("final mass:", mass, flush=True)
    from ipde_tpu_torch.utils.ledger import record
    record("coupled_advection_diffusion",
           [{"nb": nb, "M": M, "dt": DT, "steps": steps, "rel_err": rel_err,
             "mass": mass, "step_rows": step_rows}],
           ("nb", "M", "dt", "steps"), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
