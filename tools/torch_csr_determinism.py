"""Whether torch's sparse CSR product (cuSPARSE) gives the same bits run to
run on one card, by the length of the matrix's rows.

    python3 tools/torch_csr_determinism.py [--lengths 64 128 ... 1024]
                                           [--rows 40000] [--runs 5]
                                           [--problems poisson stokes
                                            stokes_3body]

First synthetic float64 CSR matrices with ``--rows`` rows of one length
each (columns random, sorted within a row): each product ``A @ q`` run
``--runs`` times and compared bit for bit with the first, and timed.  Then
the near-correction matrices of the grid evaluators of chip_smoke.py's
problems (the solver's and the BIE's): their longest row, whether their
plain product repeats bit for bit, and whether the evaluator's own
``_apply_patches`` (rows cut into pieces of at most
``ops/grid_eval.py::CSR_ROW_CHUNK`` entries, summed in order) does, each
timed.  ``CSR_ROW_CHUNK`` is read off this.  Needs a CUDA device; prints
the card's name and power limit first.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def repeats(A, q, runs, apply=None):
    """(every run of ``apply(q)`` (default ``A @ q``) bit-equal to the
    first, ms per run)."""
    apply = apply or (lambda v: A @ v)
    first = apply(q)
    same = all(torch.equal(first, apply(q)) for _ in range(runs - 1))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        apply(q)
    end.record()
    torch.cuda.synchronize()
    return same, start.elapsed_time(end) / 10


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", nargs="+", type=int,
                    default=[64, 128, 192, 256, 320, 384, 512, 768, 1024])
    ap.add_argument("--rows", type=int, default=40000)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--problems", nargs="*",
                    default=["poisson", "stokes", "stokes_3body"])
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ncol = 200000
    for L in args.lengths:
        cols = torch.randint(0, ncol, (args.rows, L), device=dev,
                             generator=gen).sort(dim=1).values
        crow = torch.arange(args.rows + 1, device=dev) * L
        vals = torch.randn(args.rows * L, dtype=torch.float64, device=dev,
                           generator=gen)
        A = torch.sparse_csr_tensor(crow.to(torch.int32),
                                    cols.reshape(-1).to(torch.int32), vals,
                                    size=(args.rows, ncol))
        q = torch.randn(ncol, dtype=torch.float64, device=dev, generator=gen)
        same, ms = repeats(A, q, args.runs)
        print(f"# rows of {L}: {args.rows} rows, {A._nnz()} entries, "
              f"{args.runs} products bit-equal: {same}, {ms:.4f} ms",
              flush=True)
        del A, cols, vals
    if not args.problems:
        return
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    builds = {"poisson": lambda: C.build_problem(dev)[4:6],
              "stokes": lambda: C.build_stokes_problem(dev)[4:6]}

    def three_body():
        from ipde_tpu_torch.solvers.bie import StokesDirichletBIE
        from ipde_tpu_torch.solvers.vector import StokesSolver
        s = StokesSolver(C.build_three_body_stokes(dev)[0])
        return s, StokesDirichletBIE(s)
    builds["stokes_3body"] = three_body
    for name in args.problems:
        solver, bie = builds[name]()
        for which, ev in (("solver", solver.grid_eval),
                          ("BIE", bie.grid_eval)):
            A = ev._patches
            q = torch.randn(A.shape[1], dtype=torch.float64, device=dev,
                            generator=gen)
            same, ms = repeats(A, q, args.runs)
            zero = torch.zeros(A.shape[0], dtype=torch.float64, device=dev)
            psame, pms = repeats(A, q, args.runs,
                                 lambda v: ev._apply_patches(zero, v))
            longest = int(A.crow_indices().diff().max())
            print(f"# {name} {which} evaluator: {A.shape[0]} rows, "
                  f"{A._nnz()} entries, longest row {longest}, "
                  f"{args.runs} products bit-equal: {same}, {ms:.4f} ms; "
                  f"in pieces ({ev._patch_rows.shape[1]} per row at most): "
                  f"bit-equal {psame}, {pms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
