"""ipde_tpu's errors on the two advection problems that chip_smoke.py runs
through the port, on the CPU, printed unrounded (the examples print two
digits):

- coupled: examples/coupled_advection_diffusion.py at its defaults:
  star(200, a=0.1, f=3), M = 10, bh = min(min_h, 0.6 / max|kappa| / M),
  qfs_tolerance 1e-12, generate_grid(bh, pad_quantum=2048), nu = 0.05,
  dt = 0.05, u = -y, v = x, the diffusing Gaussian c_exact with t0 = 0.5,
  4 steps of CoupledAdvectionDiffusionStepper (GMRES tol 1e-12); the
  relative error against c_exact and the final mass (volume_integral);
- unsteady: examples/unsteady_advection_study.py::run_case at dt = 0.05 to
  T = 0.4 (8 steps) on circle(150), M = 12, for FE, BDF2 and BDF3.

    JAX_PLATFORMS=cpu python tools/ipde_tpu_advection_reference.py \\
        [--cases coupled unsteady]

Prints one JSON line per case.  Writes nothing (both examples record into
LEDGER_TPU.json; this does not).  About 60 s per case on the CPU.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NU, DT, T0, STEPS = 0.05, 0.05, 0.5, 4


def c_exact(x, y, T):
    s = 4 * NU * (T + T0)
    return np.exp(-(x * x + y * y) / s) / (np.pi * s)


def coupled():
    from ipde_tpu.advection.stepper import CoupledAdvectionDiffusionStepper
    from ipde_tpu.functions import EmbeddedFunction
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import star
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary

    nb, M = 200, 10
    bdy = star(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)])
    ebdyc.generate_grid(bh, pad_quantum=2048)
    c = EmbeddedFunction.from_function(ebdyc,
                                       lambda x, y: c_exact(x, y, 0.0))

    def velocity(ec):
        return (EmbeddedFunction.from_function(ec, lambda x, y: -y),
                EmbeddedFunction.from_function(ec, lambda x, y: x))

    stepper = CoupledAdvectionDiffusionStepper(ebdyc, velocity, NU, DT,
                                               tol=1e-12)
    T = 0.0
    for _ in range(STEPS):
        c = stepper.step(c)
        T += DT
    ebdyc = stepper.ebdyc
    ca = EmbeddedFunction.from_function(ebdyc, lambda x, y: c_exact(x, y, T))
    err = abs(c - ca)
    phys = np.asarray(ebdyc.phys)
    ge = float(np.asarray(err.grid)[phys].max())
    re = max(float(np.abs(np.asarray(r)).max()) for r in err.radials)
    scale = float(np.asarray(ca.grid)[phys].max())
    return {"case": "coupled", "nb": nb, "M": M, "dt": DT, "steps": STEPS,
            "rel_err": max(ge, re) / scale,
            "mass": ebdyc.volume_integral(c)}


def unsteady():
    from ipde_tpu.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu.geometry.curve import circle
    from ipde_tpu.geometry.embedded_boundary import EmbeddedBoundary

    spec = importlib.util.spec_from_file_location(
        "unsteady_advection_study",
        os.path.join(ROOT, "examples", "unsteady_advection_study.py"))
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    nb, M, dt, T = 150, 12, 0.05, 0.4
    bdy = circle(nb, r=1.0)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)])
    ebdyc.generate_grid(bh)
    steps = int(round(T / dt))
    errs = {s: study.run_case(s, dt, steps, ebdyc)[0]
            for s in ("fe", "bdf2", "bdf3")}
    return {"case": "unsteady", "nb": nb, "M": M, "dt": dt, "steps": steps,
            "errors": errs}


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="+", default=["coupled", "unsteady"],
                    choices=["coupled", "unsteady"])
    args = ap.parse_args()
    for case in args.cases:
        t0 = time.perf_counter()
        out = {"coupled": coupled, "unsteady": unsteady}[case]()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
