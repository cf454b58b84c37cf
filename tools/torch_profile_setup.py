"""Where the setup of an ipde_tpu_torch solve goes, on a CUDA GPU, for both
setup backends (the counterpart of tools/profile_setup.py).

    python3 tools/torch_profile_setup.py [--cases poisson200 ... stepper]
                                         [--reps 2] [--out chiprun_out/setup]

Each case builds one collection (geometry, then generate_grid), and on it
the solver and its BIE, first with IPDE_QFS_BACKEND=host (numpy forms,
LAPACK composes and BIE inverse, uploads) and then with =device (forms born
on the card, min-norm CholeskyQR2 composes, torch.linalg.inv), ``--reps``
times in turns (host, device, device, host, ...), after one run of each
with cProfile on (not counted).  The setup is split into
wall-clock sections, each closed by torch.cuda.synchronize(): every
function below is wrapped, and a section's time is its own, without the
wrapped calls inside it:

  geometry, generate_grid        the collection (timed once per case)
  solver / helper / bie / qfs    the constructors' own work (annular
                                 solvers, plans, estimator rows, ...)
  <ctx> forms                    the dense form builders (ops/singular.py,
                                 ops/stokes_kernels.py, ops/forms_dev.py)
                                 called in that constructor
  yukawa self forms              ops/singular.py's mh_*_self (host-built on
                                 either backend)
  qfs compose                    QFSEvaluator: filters, compression, the
                                 gelsy pseudo-inverse or the min-norm compose
  <ctx> upload                   torch.as_tensor onto the card
  bie assembly + inverse         solvers/bie.py::_invert_system
  fft evaluator tables           the free-space FFT evaluators' setup

Cases (the problems of chip_smoke.py): poisson<nb> (star(nb, a=0.2, f=3),
M=16, Dirichlet) and stokes<nb> (star(nb, a=0.2, f=5), M=16) for nb 32, 64
(M=8 there), 100, 200, 400, 800 and 1200; stokes_tier1 (bench.py's tier 1:
stokes1200 with h capped for grid_target 1024 as bench.py does); mh2 (k = 2
Dirichlet, star(800, a=0.2, f=5), M=20); stepper (the moving-boundary step's setup: star(200, a=0.1, f=3),
M=10, pad_quantum 2048, ModifiedHelmholtzSolver k = 20 + NeumannBIE).  A
throwaway poisson200 setup on each backend first takes CUDA's, cuSOLVER's
and cuFFT's one-time initialisation out of the table.

Prints one line per (case, backend, rep): total seconds, the sections, the
peak device memory (torch.cuda.max_memory_allocated() over the setup), and
the shifted Cholesky retries of the device composes; then per case the
median totals and the ratio; and the sizes at which the device backend
wins.  The cProfile top 25 of each (case, backend) goes to
``--out``/<case>_<backend>.txt.  Needs a CUDA device; prints the card's
name and power limit first.
"""

import argparse
import contextlib
import cProfile
import io
import os
import pstats
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = (32, 64, 100, 200, 400, 800, 1200)
CASES = [f"poisson{n}" for n in SIZES] + [f"stokes{n}" for n in SIZES] + \
    ["stokes_tier1", "mh2", "stepper"]


class Sections:
    """Exclusive wall-clock time by section label.  A wrapped call runs
    under a context (the innermost wrapped constructor); its label is
    ``leaf`` or, for leaves named after their context, "<ctx> <leaf>"."""

    def __init__(self):
        self.stack = []
        self.own = defaultdict(float)
        self.patched = []

    def reset(self):
        self.own = defaultdict(float)

    def ctx(self):
        for name, is_ctx, _ in reversed(self.stack):
            if is_ctx:
                return name
        return "solver"

    @contextlib.contextmanager
    def section(self, name, is_ctx=True):
        self.stack.append([name, is_ctx, 0.0])
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            _, _, inner = self.stack.pop()
            self.own[name] += dt - inner
            if self.stack:
                self.stack[-1][2] += dt

    def wrap(self, owner, attr, label, is_ctx=False):
        """Replace owner.attr by a timed wrapper (undone by ``restore``).
        label: a str, or a callable of the current context returning
        one."""
        fn = getattr(owner, attr)

        def timed(*a, **k):
            name = label(self.ctx()) if callable(label) else label
            with self.section(name, is_ctx):
                return fn(*a, **k)

        self.patched.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self.patched):
            setattr(owner, attr, fn)
        self.patched = []


@contextlib.contextmanager
def instrumented():
    """A Sections over the setup's functions (``instrument``) inside the
    block; the functions are restored at its end."""
    sec = Sections()
    instrument(sec)
    try:
        yield sec
    finally:
        sec.restore()


def instrument(sec):
    """Wrap the setup's functions where their callers look them up."""
    from ipde_tpu_torch.ops import forms_dev as fd
    from ipde_tpu_torch.ops import grid_eval, singular as sq
    from ipde_tpu_torch.ops import stokes_kernels as sk
    from ipde_tpu_torch.qfs import qfs
    from ipde_tpu_torch.solvers import bie, scalar, vector

    forms = lambda ctx: f"{ctx} forms"  # noqa: E731
    for mod, names in (
            (sq, [n for n in dir(sq) if n.endswith(("_naive", "_self"))]),
            (sk, [n for n in dir(sk) if n.endswith(("_naive", "_self"))]
             + ["stokes_pressure_fix"]),
            (fd, [n for n in dir(fd) if n.endswith("_dev")
                  and not n.startswith("filter")])):
        names = [n for n in names if not n.startswith("_")]
        for name in names:
            label = ("yukawa self forms" if mod is sq
                     and name.startswith("mh_") and name.endswith("_self")
                     else forms)
            sec.wrap(mod, name, label)
    sec.wrap(torch, "as_tensor", lambda ctx: f"{ctx} upload")
    for cls, ctx in ((scalar.ScalarSolver, "solver"),
                     (vector.StokesSolver, "solver"),
                     (scalar._ScalarHelper, "helper"),
                     (vector._StokesHelper, "helper"),
                     (bie.DirichletBIE, "bie"), (bie.NeumannBIE, "bie"),
                     (bie.StokesDirichletBIE, "bie")):
        sec.wrap(cls, "__init__", ctx, is_ctx=True)
    sec.wrap(qfs.QFSEvaluator, "__init__", "qfs compose", is_ctx=True)
    # the QFS constructors, where their callers bound them by name
    for mod in (qfs, scalar, vector, bie):
        for name in ("laplace_qfs", "mh_qfs", "stokes_qfs"):
            if hasattr(mod, name):
                sec.wrap(mod, name, "qfs", is_ctx=True)
    sec.wrap(bie, "_invert_system", "bie assembly + inverse")
    for cls in (grid_eval.FreespaceGridEvaluator,
                grid_eval.StokesFreespaceGridEvaluator):
        sec.wrap(cls, "__init__", "fft evaluator tables", is_ctx=True)


def build_collection(case, dev, sec):
    from ipde_tpu_torch.geometry.collection import EmbeddedBoundaryCollection
    from ipde_tpu_torch.geometry.curve import star
    from ipde_tpu_torch.geometry.embedded_boundary import EmbeddedBoundary
    sec.reset()
    with sec.section("geometry"):
        if case == "stepper":
            nb, M, a, f = 200, 10, 0.1, 3
        elif case == "mh2":
            nb, M, a, f = 800, 20, 0.2, 5
        elif case == "stokes_tier1":
            nb, M, a, f = 1200, 16, 0.2, 5
        else:
            nb = int("".join(filter(str.isdigit, case)))
            M, a, f = (16 if nb >= 100 else 8), 0.2, \
                3 if case.startswith("poisson") else 5
        bdy = star(nb, a=a, f=f)
        bh = min(bdy.min_h(), 0.6 / np.abs(bdy.curvature).max() / M)
        if case == "stokes_tier1":
            bh = min(bh, float(bdy.x.max() - bdy.x.min()) / (1024 - 3 * M))
        tol = 1e-12 if case == "stepper" else 1e-14
        ebdyc = EmbeddedBoundaryCollection(
            [EmbeddedBoundary(bdy, True, M, bh, qfs_tolerance=tol)],
            device=dev)
    with sec.section("generate_grid"):
        grid = ebdyc.generate_grid(
            bh, pad_quantum=2048 if case == "stepper" else None)
    return ebdyc, grid, dict(sec.own)


def build_setup(case, ebdyc):
    """The solver and its BIE of ``case`` on ``ebdyc``."""
    from ipde_tpu_torch.solvers.bie import (DirichletBIE, NeumannBIE,
                                            StokesDirichletBIE)
    from ipde_tpu_torch.solvers.scalar import (ModifiedHelmholtzSolver,
                                               PoissonSolver)
    from ipde_tpu_torch.solvers.vector import StokesSolver
    if case.startswith("poisson"):
        solver = PoissonSolver(ebdyc)
        return solver, DirichletBIE(solver)
    if case.startswith("stokes"):
        solver = StokesSolver(ebdyc)
        return solver, StokesDirichletBIE(solver)
    if case == "mh2":
        solver = ModifiedHelmholtzSolver(ebdyc, k=2.0)
        return solver, DirichletBIE(solver)
    solver = ModifiedHelmholtzSolver(ebdyc, k=20.0)
    return solver, NeumannBIE(solver)


def shifted_retries(solver, bie):
    """The shifted Cholesky retries of every QFS compose of a setup."""
    qs = list(bie.qfs_list)
    for h in solver.helpers:
        qs += [h.qfs_g, h.qfs_r]
    return sum(q.shifted_retries for q in qs)


@contextlib.contextmanager
def forced_backend(backend):
    """IPDE_QFS_BACKEND (which the BIEs follow) set to ``backend`` inside
    the block."""
    old = os.environ.get("IPDE_QFS_BACKEND")
    os.environ["IPDE_QFS_BACKEND"] = backend
    try:
        yield
    finally:
        if old is None:
            del os.environ["IPDE_QFS_BACKEND"]
        else:
            os.environ["IPDE_QFS_BACKEND"] = old


def one_setup(make, backend, sec, profile_to=None):
    """``make()`` -> (solver, bie) built on ``backend`` under the sections
    ``sec`` (reset first), with cProfile's top 25 written to ``profile_to``
    when given.  Returns (solver, bie, seconds, sections, peak device GiB,
    shifted retries)."""
    with forced_backend(backend):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sec.reset()
        prof = cProfile.Profile() if profile_to else None
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        with sec.section("solver"):
            solver, bie = make()
        if prof:
            prof.disable()
        total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (bie.A_dev is not None) != (backend == "device"):
        raise RuntimeError(f"the {backend} setup backend was not taken")
    if prof:
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(25)
        with open(profile_to, "w") as fh:
            fh.write(s.getvalue())
    return solver, bie, total, dict(sec.own), peak, shifted_retries(solver,
                                                                     bie)


def fmt(own):
    return ", ".join(f"{k} {v:.3f}" for k, v in
                     sorted(own.items(), key=lambda kv: -kv[1]) if v >= 5e-4)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="+", default=CASES, choices=CASES)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "setup"))
    args = ap.parse_args()
    from ipde_tpu_torch.config import require_cuda
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    with instrumented() as sec:
        run(args, dev, sec)


def run(args, dev, sec):
    warm, _, _ = build_collection("poisson200", dev, sec)
    for backend in ("host", "device"):
        one_setup(lambda: build_setup("poisson200", warm), backend, sec)
    totals = {}
    for case in args.cases:
        ebdyc, grid, geo = build_collection(case, dev, sec)
        nb = ebdyc.ebdys[0].bdy.N
        print(f"# {case}: nb {nb}, grid {tuple(grid.shape)}; "
              f"{fmt(geo)} s", flush=True)
        make = lambda: build_setup(case, ebdyc)  # noqa: E731
        for backend in ("host", "device"):
            total, own = one_setup(
                make, backend, sec,
                os.path.join(args.out, f"{case}_{backend}.txt"))[2:4]
            print(f"# {case} [{backend}] profiler on: setup {total:.3f} s "
                  f"({fmt(own)})", flush=True)
        got = defaultdict(list)
        for r in range(args.reps):
            for backend in (("host", "device") if r % 2 == 0
                            else ("device", "host")):
                total, own, peak, retries = one_setup(make, backend,
                                                      sec)[2:]
                got[backend].append(total)
                print(f"# {case} [{backend}] rep {r + 1}: setup {total:.3f} "
                      f"s ({fmt(own)}); peak device memory {peak:.3f} GiB; "
                      f"shifted retries {retries}", flush=True)
        med = {b: statistics.median(v) for b, v in got.items()}
        totals[case] = (nb, med)
        print(f"# {case}: median setup host {med['host']:.3f} s, device "
              f"{med['device']:.3f} s, host / device "
              f"{med['host'] / med['device']:.2f}", flush=True)
    wins = sorted(nb for nb, med in totals.values()
                  if med["device"] < med["host"])
    loses = sorted(nb for nb, med in totals.values()
                   if med["device"] >= med["host"])
    print(f"# device backend faster at nb {wins}, not at nb {loses}",
          flush=True)


if __name__ == "__main__":
    main()
