"""Time the dense layer-potential kernels at the six launch shapes of each
chip_smoke.py problem, without building the solvers.

    python3 tools/torch_kernel_shapes.py [--root DIR] [--check] [--reps 20]
                                         [--problems poisson stokes mh2 mh100]
                                         [--row-major]

Builds only the geometry of a problem (curve, embedded boundary, box grid:
seconds, where the solvers' QFS maps take up to minutes), then the inputs of
the six dense-kernel launches of one solve, as the solvers form them: the
merged apply (interface QFS sources -> grid points outside the annulus +
interface points), the two radial groups of the annular correction, the BIE's
grid apply (boundary QFS sources -> every physical grid point) and its two
radial groups.  The ``poisson`` problem times both Laplace kernels there: the
single layer (the solve's six launches) and its gradient (no solver calls
it: the same six shapes).  Charges are random (seeded).  Grid targets are put in
``ops.kernels.spatial_order`` where the package has it and the solver uses it
(the Yukawa problems), unless ``--row-major``.  Each launch is timed with
CUDA events (kernel only) beside its bound (chip_smoke.bound_ms /
mh_bound_ms), run twice and compared bit for bit, and with ``--check`` held
to the plain version at 1e-12.  For the Yukawa launches the share of
(warp, source) pairs in more than one K0 branch is printed as well.

``--root DIR`` imports ``ipde_tpu_torch`` from another checkout (an earlier
commit unpacked there), so two versions can be timed in one run on one card:
this file uses only what both have.  Needs a CUDA device; prints the card's
name and power limit first and one JSON line per launch.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (pde, k, nb, M, grid_target, lobes f of star(nb, a=0.2, f))
PROBLEMS = {"poisson": ("laplace", None, 1200, 16, None, 3),
            "stokes": ("stokes", None, 1200, 16, 1024, 5),
            "mh2": ("mh", 2.0, 800, 20, None, 5),
            "mh100": ("mh", 100.0, 600, 24, None, 5)}


def launches(name, dev, ordered):
    """[(label, (sx, sy, w, tx, ty))] of one solve's six launches."""
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    from ipde_tpu_torch.ops import kernels
    from ipde_tpu_torch.ops.stratified import StratifiedRadialApply

    pde, k, nb, M, grid_target, lobes = PROBLEMS[name]
    bdy = star(nb, a=0.2, f=lobes)
    bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
    if grid_target:
        bh = min(bh, float(bdy.x.max() - bdy.x.min()) / (grid_target - 3 * M))
    e = EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=1e-14)
    ebdyc = EmbeddedBoundaryCollection([e], device=dev)
    grid = ebdyc.generate_grid(bh)
    alpha = None
    if pde == "mh":     # ModifiedHelmholtzSolver._qfs_alpha
        alpha = float(np.clip(1.5 + 0.5 * k * 2.0 * np.pi / nb, 1.5, 3.0))
    dev_t = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float64), device=dev)
    rng = np.random.default_rng(11)
    order = getattr(kernels, "spatial_order", None)
    if not (ordered and pde == "mh"):
        order = None
    cell = min(grid.xh, grid.yh)

    def grid_targets(x, y):
        x, y = dev_t(x), dev_t(y)
        if order is not None:
            perm = order(x, y, cell=cell)
            x, y = x[perm].contiguous(), y[perm].contiguous()
        return x, y

    def curve_launch(label, src, tx, ty):
        w = dev_t(rng.standard_normal(src.N) * src.weights)
        return label, (dev_t(src.x), dev_t(src.y), w, tx, ty)

    out = []
    grid_src = e.qfs_source_for_side("interface", interior_eval=True,
                                     alpha=alpha)
    px, py = grid_targets(ebdyc.pna_x, ebdyc.pna_y)
    out.append(curve_launch(
        "merged", grid_src,
        torch.cat([px, ebdyc.all_interface_x_dev]),
        torch.cat([py, ebdyc.all_interface_y_dev])))
    radial_src = e.qfs_source_for_side("interface", interior_eval=False,
                                       alpha=alpha)
    bie_src = e.qfs_source_for_side("bdy", interior_eval=True, alpha=alpha)
    phys = ebdyc.phys

    def radial(label, src):
        plan = StratifiedRadialApply(src, e.radial_x, e.radial_y,
                                     k_density=nb // 2, device=dev)
        for f, tx, ty, gsx, gsy, gw in plan.groups:
            w = dev_t(rng.standard_normal(gsx.shape[0])) * gw
            out.append((f"{label} radial stride {f}", (gsx, gsy, w, tx, ty)))

    radial("correction", radial_src)
    out.append(curve_launch("BIE grid", bie_src,
                            *grid_targets(grid.xg[phys], grid.yg[phys])))
    radial("BIE", bie_src)
    return pde, k, out


def cuda_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--problems", nargs="+", default=list(PROBLEMS),
                    choices=list(PROBLEMS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--row-major", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs     # this checkout's, whatever --root is
    sys.path.insert(0, os.path.abspath(args.root))
    from ipde_tpu_torch.config import require_cuda
    from ipde_tpu_torch.ops import kernels, stokes_kernels
    assert os.path.abspath(kernels.__file__).startswith(
        os.path.abspath(args.root)), kernels.__file__
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"# root {os.path.abspath(args.root)} row_major {args.row_major}",
          flush=True)
    for name in args.problems:
        pde, k, todo = launches(name, dev, not args.row_major)
        for label, (sx, sy, w, tx, ty) in todo:
            for kernel in {"laplace": ("laplace_slp", "laplace_grad"),
                           "stokes": ("stokes_slp",), "mh": ("mh_slp",)}[pde]:
                time_launch(args, cs, kernels, stokes_kernels, name, label,
                            kernel, (sx, sy, w, tx, ty), k)


def time_launch(args, cs, kernels, stokes_kernels, name, label, kernel,
                inputs, k):
    """One launch of ``kernel`` on ``inputs``: print its JSON line; exit if
    two runs differ or ``--check`` finds it off the plain version."""
    sx, sy, w, tx, ty = inputs
    S, T = sx.shape[0], tx.shape[0]
    row = {"problem": name, "launch": label, "kernel": kernel, "T": T, "S": S}
    if kernel == "stokes_slp":
        w2 = w.flip(0).contiguous()
        run = lambda: stokes_kernels.stokes_slp_apply(  # noqa: E731
            sx, sy, w, w2, tx, ty)
        plain = lambda: stokes_kernels.stokes_slp_apply_plain(  # noqa: E731
            sx, sy, w, w2, tx, ty)
        err = cs.stokes_err
    elif kernel == "mh_slp":
        run = lambda: (kernels.mh_slp_apply(  # noqa: E731
            sx, sy, w, tx, ty, k),)
        plain = lambda: (kernels.mh_slp_apply_plain(  # noqa: E731
            sx, sy, w, tx, ty, k),)
        err = lambda g, p: cs.laplace_err(g[0], p[0])  # noqa: E731
    elif kernel == "laplace_slp":
        run = lambda: (kernels.laplace_slp_apply(  # noqa: E731
            sx, sy, w, tx, ty),)
        plain = lambda: (kernels.laplace_slp_apply_plain(  # noqa: E731
            sx, sy, w, tx, ty),)
        err = lambda g, p: cs.laplace_err(g[0], p[0])  # noqa: E731
    else:
        run = lambda: kernels.laplace_slp_grad_apply(  # noqa: E731
            sx, sy, w, tx, ty)
        plain = lambda: kernels.laplace_slp_grad_apply_plain(  # noqa: E731
            sx, sy, w, tx, ty)
        err = cs.grad_err
    if kernel == "mh_slp":
        bnd, _, counts = cs.mh_bound_ms(sx, sy, tx, ty, k)
        row["bound_ms"] = bnd
        row["pairs"] = counts
        row["diverged"] = cs.mh_divergence_share(sx, sy, tx, ty, k)
    else:
        row["bound_ms"] = cs.bound_ms(kernel, S, T)[0]
    a, b = run(), run()
    torch.cuda.synchronize()
    row["bit_equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
    if args.check:
        row["max_rel"] = err(a, plain())[1]
    row["ms"] = cuda_ms(run, args.reps)
    print(json.dumps(row), flush=True)
    if not row["bit_equal"] or row.get("max_rel", 0.0) > 1e-12:
        raise SystemExit(f"{name} {label}: {row}")

if __name__ == "__main__":
    main()
