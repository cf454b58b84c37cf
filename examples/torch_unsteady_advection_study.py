"""Unsteady-velocity semi-Lagrangian order study on the port
(ipde_tpu_torch, on the card): the counterpart of
examples/unsteady_advection_study.py, FE vs BDF2 vs BDF3 on the rotation of
rate w(t) = 1 + 0.5 sin(2t) on a CIRCLE boundary (a streamline: the
advectors run with the boundary fixed), history from the exact solution,
compared with the closed-form transported field.  Same sweep (ADV_DTS,
ADV_NB, ADV_M, ADV_T), order check (last row: FE > 0.7, BDF2 > 1.6,
BDF3 > 2.5) and exit code as the reference.  Rows go into LEDGER_TORCH.json
under "unsteady_advection@<card>" with the seconds per step.

The port's ThirdOrderAdvector captures 3 umax dt in its first partition
(ipde_tpu passes 0; ROADMAP.md Queue 3), so its BDF3 errors may differ from
ipde_tpu's in the last digits.

Usage:
    python examples/torch_unsteady_advection_study.py          # on the card
    python examples/torch_unsteady_advection_study.py --device cpu
    ADV_DTS="0.1 0.05 0.025" ADV_NB=150 ADV_M=12 python examples/torch_unsteady_advection_study.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_common as common  # noqa: E402


def OMEGA(t):
    return 1.0 + 0.5 * np.sin(2.0 * t)


def ALPHA(t):
    return t + 0.25 * (1.0 - np.cos(2.0 * t))


def F0(x, y):
    return np.exp(np.sin(x)) * np.cos(y + 0.3)


def exact(x, y, t):
    a = ALPHA(t)
    c, s = np.cos(a), np.sin(a)
    return F0(c * x + s * y, -s * x + c * y)


class _Hist:
    def __init__(self, u, v, uo, vo):
        self.u, self.v, self.uo, self.vo = u, v, uo, vo


def build_collection(nb, M, device=None):
    """circle(nb) with M radial points on ``device`` (None: the card)."""
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import circle
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    bdy = circle(nb, r=1.0)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    ebdyc = EmbeddedBoundaryCollection(
        [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-12)],
        device=device)
    ebdyc.generate_grid(bh)
    return ebdyc


def run_case(scheme, dt, steps, ebdyc):
    """``scheme`` ("fe", "bdf2", "bdf3") for ``steps`` steps of dt on the
    collection ``ebdyc`` (build_collection: it carries the device); returns
    (max error, seconds per step)."""
    from ipde_tpu_torch.advection.semi_lagrangian import (
        SecondOrderAdvector, SemiLagrangianAdvector, ThirdOrderAdvector)
    from ipde_tpu_torch.functions import EmbeddedFunction
    from ipde_tpu_torch.utils.profiling import sync

    def vel(t):
        w = OMEGA(t)
        return (EmbeddedFunction.from_function(ebdyc, lambda x, y: -w * y),
                EmbeddedFunction.from_function(ebdyc, lambda x, y: w * x))

    def ex(t):
        return EmbeddedFunction.from_function(
            ebdyc, lambda x, y: exact(x, y, t))

    f, fm1, fm2 = ex(0.0), ex(-dt), ex(-2 * dt)
    t = 0.0
    prev_adv = None
    t0 = time.perf_counter()
    for _ in range(steps):
        u, v = vel(t)
        if scheme == "fe":
            adv = SemiLagrangianAdvector(ebdyc, u, v)
            adv.generate(dt, fixed_boundary=True)
            fn = adv(f)
        elif scheme == "bdf2":
            if prev_adv is None:
                prev_adv = SemiLagrangianAdvector(ebdyc, *vel(t - dt))
                prev_adv.generate(dt, fixed_boundary=True)
            adv = SecondOrderAdvector(ebdyc, u, v, prev_adv)
            adv.generate(dt, fixed_boundary=True)
            fn = adv.advect_bdf2(f, fm1)
        else:
            adv = ThirdOrderAdvector(ebdyc, u, v,
                                     _Hist(*vel(t - dt), *vel(t - 2 * dt)))
            adv.generate(dt)
            fn = adv(f, fm1, fm2)
        prev_adv = adv
        fm2, fm1, f = fm1, f, fn
        t += dt
    sync(f)
    step_s = (time.perf_counter() - t0) / steps
    return common.max_err(ebdyc, f, lambda x, y: exact(x, y, t)), step_s


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    nb = int(os.environ.get("ADV_NB", 150))
    # zone-1 spectral interpolation has a ~4e-7 floor at M=8 from the
    # Slepian rolloff band-limit: use M >= 12 for order studies
    M = int(os.environ.get("ADV_M", 12))
    dts = [float(s) for s in
           os.environ.get("ADV_DTS", "0.1 0.05 0.025").split()]
    T_final = float(os.environ.get("ADV_T", 0.4))
    ebdyc = build_collection(nb, M, device)
    schemes = ("fe", "bdf2", "bdf3")
    print(f"{'dt':>8} " + " ".join(f"{'err_' + s:>12} {'ord':>5}"
                                   for s in schemes) + f" {'s/step':>18}",
          flush=True)
    rows, prev = [], {}
    for dt in dts:
        steps = max(int(round(T_final / dt)), 1)
        out = {s: run_case(s, dt, steps, ebdyc) for s in schemes}
        row = {"dt": dt}
        line = f"{dt:8.4f} "
        for s in schemes:
            e = out[s][0]
            o = (np.log2(prev[s] / e) / np.log2(prev["dt"] / dt)
                 if prev else float("nan"))
            line += f"{e:12.6e} {o:5.2f} "
            row[f"err_{s}"] = e
            row[f"order_{s}"] = None if np.isnan(o) else float(o)
            row[f"step_s_{s}"] = out[s][1]
        print(line + " ".join(f"{out[s][1]:.3f}" for s in schemes),
              flush=True)
        rows.append(row)
        prev = dict({s: out[s][0] for s in schemes}, dt=dt)
    ok = True
    if len(rows) >= 2:
        last = rows[-1]
        ok = (last["order_fe"] > 0.7 and last["order_bdf2"] > 1.6
              and last["order_bdf3"] > 2.5)
        print("orders OK" if ok else "ORDER CHECK FAILED", flush=True)
    from ipde_tpu_torch.utils.ledger import record
    record("unsteady_advection",
           [{"nb": nb, "M": M, "T": T_final, "rows": rows,
             "orders_ok": bool(ok)}], ("nb", "M", "T"), device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
