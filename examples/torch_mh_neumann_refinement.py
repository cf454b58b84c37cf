"""Interior modified-Helmholtz NEUMANN refinement study on the port
(ipde_tpu_torch, on the card): the counterpart of
examples/mh_neumann_refinement.py, with its problem, sweep, reference
values and rule (reference:
examples/interior_modified_helmholtz_using_multi_neumann_bc.py:119-130:
k^2=1 converges to 9.82e-10, k^2=1e4 to 4.10e-09).

Runs the Neumann-BC solve (ModifiedHelmholtzSolver, fft grid backend, then
NeumannBIE.apply_bc) at increasing boundary resolution for k^2 = 1 and
k^2 = 1e4 and records err, setup_s, first_s and solve_ms (the median of 5
warm solves with min and max, read after torch.cuda.synchronize()) into
LEDGER_TORCH.json under "mh_neumann_refinement@<card>".  Pass criterion:
for each k the best row within 3 x the reference's converged value; exit
code 1 otherwise.  GMRES tol 1e-13 as in the reference; see
examples/_torch_common.py for the port's rule.

Usage:
    python examples/torch_mh_neumann_refinement.py            # on the card
    python examples/torch_mh_neumann_refinement.py --device cpu
    MHN_CASES="1.0:200,10 1.0:400,16" python examples/torch_mh_neumann_refinement.py
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_common as common  # noqa: E402


def sol(x, y):
    return np.exp(np.sin(x)) * np.sin(2 * y) + 0.3 * np.cos(3 * x) * np.cos(y)


def lap_sol(x, y):
    u1xx = np.exp(np.sin(x)) * (np.cos(x) ** 2 - np.sin(x)) * np.sin(2 * y)
    u1 = np.exp(np.sin(x)) * np.sin(2 * y)
    u2 = 0.3 * np.cos(3 * x) * np.cos(y)
    return u1xx - 4 * u1 - 10 * u2


def grad_sol(x, y):
    ux = (np.cos(x) * np.exp(np.sin(x)) * np.sin(2 * y)
          - 0.9 * np.sin(3 * x) * np.cos(y))
    uy = (2 * np.exp(np.sin(x)) * np.cos(2 * y)
          - 0.3 * np.cos(3 * x) * np.sin(y))
    return ux, uy


def run_case(k, nb, M, tol=1e-13, device=None):
    """One row on ``device`` (None: the card)."""
    from ipde_tpu_torch.functions import BoundaryFunction, EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.solvers.bie import NeumannBIE
    from ipde_tpu_torch.solvers.scalar import ModifiedHelmholtzSolver
    from ipde_tpu_torch.utils.profiling import sync, time_solves

    t0 = time.perf_counter()
    bdy = star(nb, a=0.2, f=5)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdy = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([ebdy], device=device)
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(
        ebdyc, lambda x, y: k**2 * sol(x, y) - lap_sol(x, y))
    ux, uy = grad_sol(bdy.x, bdy.y)
    bcn = BoundaryFunction([torch.as_tensor(
        ux * bdy.normal_x + uy * bdy.normal_y, device=ebdyc.device)])
    solver = ModifiedHelmholtzSolver(ebdyc, k=k)
    bie = NeumannBIE(solver)
    sync(f)
    setup_s = time.perf_counter() - t0

    def run():
        ue, st = solver.solve_with_stats(f, tol=tol)
        return bie.apply_bc(ue, bcn), st

    (ue, st), times = time_solves(run, common.WARM_SOLVES)
    return {"k2": k * k, "nb": nb, "M": M,
            "err": common.max_err(ebdyc, ue, sol), "setup_s": setup_s,
            **times, "iterations": st["annular_iterations"],
            "residual": max(st["annular_residuals"]), "tol": tol}


# reference converged values per k^2 (same file :120,:128)
REFERENCE_ERR = {1.0: 9.82e-10, 1e4: 4.10e-09}


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    spec = os.environ.get(
        "MHN_CASES", "1.0:200,10 1.0:400,16 100.0:400,20 100.0:600,24")
    cases = []
    for c in spec.split():
        kpart, rest = c.split(":")
        nb, M = rest.split(",")
        cases.append((float(kpart), int(nb), int(M)))
    print("# " + common.TOL_RULE, flush=True)
    print(f"{'k^2':>8} {'nb':>6} {'M':>3} {'err':>10} {'ref_err':>10} "
          f"{common.TIME_HEAD}", flush=True)
    rows, best = [], {}
    for k, nb, M in cases:
        row = run_case(k, nb, M, device=device)
        rows.append(row)
        ref = REFERENCE_ERR.get(k * k)
        print(f"{k * k:>8.0f} {nb:>6} {M:>3} {row['err']:>10.4e} "
              f"{(f'{ref:.4e}' if ref else '-'):>10} {common.time_cols(row)}",
              flush=True)
        best[k * k] = min(best.get(k * k, np.inf), row["err"])
    ok = all(best[k2] <= 3 * REFERENCE_ERR[k2]
             for k2 in best if k2 in REFERENCE_ERR)
    from ipde_tpu_torch.utils.ledger import record
    record("mh_neumann_refinement", rows, ("k2", "nb", "M"), device=device)
    print("all ledger rows met" if ok else "ledger rows FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
