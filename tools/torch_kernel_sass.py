"""Instruction counts of the port's CUDA kernels, read from their SASS.

    python3 tools/torch_kernel_sass.py [--stems laplace_slp laplace_grad
                                        stokes_slp mh_slp] [--root DIR]
                                       [--out build/sass] [--paths] [--ncu]

Builds ``ipde_tpu_torch/csrc/<stem>.cu`` as the port does (nvcc, sm_90a),
disassembles the library with ``cuobjdump -sass`` and, for every kernel and
every loop of it (a branch back to a lower address), prints the
instructions of the loop by opcode: the FP64 ones (DFMA, DMUL, DADD, DSETP,
DMNMX), MUFU, the shared-memory loads (LDS), the conversions to and from
64-bit types (I2F, F2I, F2F: they run at a fraction of the FP64 rate) and
the rest.  Loops are
listed innermost (shortest) first; a loop that the compiler unrolled holds
several source iterations, so divide by the number of pairs that its LDS
count implies.  ``--paths`` cuts the innermost loop with FP64 work into its
straight-line segments, so that the instructions of each branch of a loop
body (the Yukawa kernel's K0) can be added up along it.  The whole
disassembly goes to ``--out``.  ``--root DIR`` reads the sources of another
checkout (an earlier commit unpacked there).  ``--ncu`` also
tries Nsight Compute's FP64 pipe counters on one Stokeslet apply and says
whether the machine permits them.  The registers, shared memory and
spills that ptxas reports are printed first.  Needs the CUDA toolkit; the
counts themselves need no card.
"""

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"\s*([^;]*);")
FP64 = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")
CONVERSIONS = ("I2F", "F2I", "F2F")
NCU_SNIPPET = """
import torch, sys
sys.path.insert(0, %r)
from ipde_tpu_torch.ops import stokes_kernels as SK
g = torch.Generator(device="cuda").manual_seed(0)
s = [torch.rand(3600, device="cuda", dtype=torch.float64, generator=g)
     for _ in range(4)]
t = [torch.rand(100000, device="cuda", dtype=torch.float64, generator=g)
     for _ in range(2)]
SK.stokes_slp_apply(*s, *t)
torch.cuda.synchronize()
"""


def tool(name):
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def functions(sass):
    """{kernel name: [(address, opcode, operands)]} of a cuobjdump listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def loops(instrs):
    """[(start address, end address)] of the backward branches, shortest
    first."""
    found = set()
    for addr, op, args in instrs:
        if op.split(".")[0] == "BRA":
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) <= addr:
                found.add((int(m.group(1), 16), addr))
    return sorted(found, key=lambda se: se[1] - se[0])


def histogram(instrs, start, end):
    c = collections.Counter(op.split(".")[0] for a, op, _ in instrs
                            if start <= a <= end)
    fp64 = {k: c.pop(k) for k in FP64 if k in c}
    mufu = c.pop("MUFU", 0)
    lds = c.pop("LDS", 0)
    conv = sum(c.pop(k, 0) for k in CONVERSIONS)
    return fp64, mufu, lds, conv, c


CONTROL = ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BREAK")


def segments(instrs, start, end):
    """The loop start..end cut at its control-flow instructions: one line
    per straight-line segment with its FP64 and other instruction counts,
    then the control instruction that ends it.  Adding the segments along
    one path of a branching loop gives that path's count per iteration."""
    fp64 = other = 0
    for addr, op, args in instrs:
        if not start <= addr <= end:
            continue
        base = op.split(".")[0]
        if base in CONTROL:
            print(f"#     [{fp64} FP64, {other} other] {addr:#06x} {op} "
                  f"{args.strip()}")
            fp64 = other = 0
        elif base in FP64:
            fp64 += 1
        else:
            other += 1


def ptxas_info(stem):
    """Registers, shared memory and spills of each kernel, as ptxas
    reports them for the port's own compile command."""
    import tempfile
    from ipde_tpu_torch.ops import kernels as K
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [K._nvcc(), *K._NVCC_FLAGS, "-Xptxas", "-v",
             str(K._CSRC / f"{stem}.cu"), "-o", os.path.join(tmp, "a.so")],
            capture_output=True, text=True, check=True)
    for line in res.stderr.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(f"# {stem} ptxas: {line.replace('ptxas info    : ', '')}")


def report(stem, out_dir, paths=False):
    from ipde_tpu_torch.ops import kernels as K
    ptxas_info(stem)
    lib = K.library_path(stem)
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{stem}.sass"), "w") as fh:
        fh.write(sass)
    for name, instrs in functions(sass).items():
        fp64, mufu, lds, conv, rest = histogram(instrs, 0, 1 << 62)
        print(f"# {stem}: {name}: {len(instrs)} instructions, FP64 "
              f"{sum(fp64.values())} {fp64}, MUFU {mufu}, LDS {lds}, "
              f"conversions {conv}")
        for start, end in loops(instrs):
            fp64, mufu, lds, conv, rest = histogram(instrs, start, end)
            print(f"#   loop {start:#06x}-{end:#06x}: FP64 "
                  f"{sum(fp64.values())} {fp64}, MUFU {mufu}, LDS {lds}, "
                  f"conversions {conv}, "
                  f"other {sum(rest.values())} {dict(rest.most_common(10))}")
        inner = [se for se in loops(instrs)
                 if histogram(instrs, *se)[0]]
        if paths and inner:     # the innermost loop that holds FP64 work
            print(f"#   segments of loop {inner[0][0]:#06x}-{inner[0][1]:#06x}:")
            segments(instrs, *inner[0])


def try_ncu():
    try:
        ncu = tool("ncu")
    except RuntimeError as exc:
        print(f"# ncu: {exc}")
        return
    try:
        res = subprocess.run(
            [ncu, "--metrics", "smsp__inst_executed_pipe_fp64.sum,"
             "sm__throughput.avg.pct_of_peak_sustained_elapsed",
             "-k", "regex:stokes_slp", sys.executable, "-c",
             NCU_SNIPPET % ROOT],
            capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        print("# ncu: no result within 240 s")
        return
    tail = (res.stdout + res.stderr).strip().splitlines()[-12:]
    print(f"# ncu exit code {res.returncode}; the end of its output:")
    for line in tail:
        print(f"#   {line}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stems", nargs="+",
                    default=["laplace_slp", "laplace_grad", "stokes_slp",
                             "mh_slp"])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose ipde_tpu_torch is read")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sass"))
    ap.add_argument("--ncu", action="store_true")
    ap.add_argument("--paths", action="store_true",
                    help="also cut each kernel's innermost FP64 loop into "
                    "its straight-line segments")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    for stem in args.stems:
        report(stem, args.out, args.paths)
    if args.ncu:
        try_ncu()


if __name__ == "__main__":
    main()
