"""Semi-Lagrangian accuracy-order study on the port (ipde_tpu_torch, on the
card): the counterpart of examples/advection_convergence.py, FE vs BDF2
under dt refinement on a rigidly rotating flow with a MOVING boundary (the
boundary is advected, reparametrized, and the geometry regenerated every
step), compared with the exact transported field.  Same sweep (ADV_DTS,
ADV_NB, ADV_M, ADV_T), order check (last row: FE > 0.7, BDF2 > 1.6) and
exit code as the reference.  Rows go into LEDGER_TORCH.json under
"advection_convergence@<card>" with the seconds per step (host clock, the
card synchronized at the end of each run).  No solve runs here: the
advectors' partitions, Newton coordinates and interpolations only.

Usage:
    python examples/torch_advection_convergence.py            # on the card
    python examples/torch_advection_convergence.py --device cpu
    ADV_DTS="0.1 0.05" ADV_NB=150 python examples/torch_advection_convergence.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_common as common  # noqa: E402


def f0(x, y):
    return np.exp(np.sin(x)) * np.cos(y + 0.3)


def exact(x, y, T):
    c, s = np.cos(T), np.sin(T)
    return f0(c * x + s * y, -s * x + c * y)


def run_case(dt, steps, order2, nb, M, device=None):
    """FE (order2 False) or BDF2 for ``steps`` steps of dt on ``device``
    (None: the card); returns (max error, seconds per step)."""
    from ipde_tpu_torch.advection.semi_lagrangian import (
        SecondOrderAdvector, SemiLagrangianAdvector)
    from ipde_tpu_torch.functions import EmbeddedFunction
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.utils.profiling import sync

    bdy = star(nb, a=0.1, f=3)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
        device=device)
    ebdyc.generate_grid(bh)
    f = EmbeddedFunction.from_function(ebdyc, f0)
    f_prev = adv_prev = None
    T = 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        u = EmbeddedFunction.from_function(ebdyc, lambda x, y: -y)
        v = EmbeddedFunction.from_function(ebdyc, lambda x, y: x)
        if order2 and adv_prev is not None:
            adv = SecondOrderAdvector(ebdyc, u, v, adv_prev)
            new_ebdyc = adv.generate(dt)
            fn = adv.advect_bdf2(f, f_prev)
        else:
            adv = SemiLagrangianAdvector(ebdyc, u, v)
            new_ebdyc = adv.generate(dt)
            fn = adv(f)
        f_prev, adv_prev = f, adv
        f, ebdyc = fn, new_ebdyc
        T += dt
    sync(f)
    step_s = (time.perf_counter() - t0) / steps
    return common.max_err(ebdyc, f, lambda x, y: exact(x, y, T)), step_s


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    nb = int(os.environ.get("ADV_NB", 200))
    M = int(os.environ.get("ADV_M", 10))
    dts = [float(s) for s in
           os.environ.get("ADV_DTS", "0.1 0.05 0.025").split()]
    T_final = float(os.environ.get("ADV_T", 0.2))
    print(f"{'dt':>8} {'err_FE':>12} {'ord':>5} {'err_BDF2':>12} {'ord':>5} "
          f"{'s/step':>7}", flush=True)
    rows, prev = [], {}
    for dt in dts:
        steps = max(int(round(T_final / dt)), 1)
        e1, s1 = run_case(dt, steps, False, nb, M, device)
        e2, s2 = run_case(dt, steps, True, nb, M, device)
        o1 = (np.log2(prev["e1"] / e1) / np.log2(prev["dt"] / dt)
              if prev else float("nan"))
        o2 = (np.log2(prev["e2"] / e2) / np.log2(prev["dt"] / dt)
              if prev else float("nan"))
        print(f"{dt:8.4f} {e1:12.6e} {o1:5.2f} {e2:12.6e} {o2:5.2f} "
              f"{0.5 * (s1 + s2):7.3f}", flush=True)
        rows.append({"dt": dt, "err_fe": e1, "err_bdf2": e2,
                     "order_fe": None if np.isnan(o1) else float(o1),
                     "order_bdf2": None if np.isnan(o2) else float(o2),
                     "step_s_fe": s1, "step_s_bdf2": s2})
        prev = {"dt": dt, "e1": e1, "e2": e2}
    ok = True
    if len(rows) >= 2:
        ok = rows[-1]["order_fe"] > 0.7 and rows[-1]["order_bdf2"] > 1.6
        print("orders OK" if ok else "ORDER CHECK FAILED", flush=True)
    from ipde_tpu_torch.utils.ledger import record
    record("advection_convergence",
           [{"nb": nb, "M": M, "T": T_final, "rows": rows,
             "orders_ok": bool(ok)}], ("nb", "M", "T"), device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
