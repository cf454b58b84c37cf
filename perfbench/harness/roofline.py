"""The least time the card could take for a layer-potential sum.

Frozen copy of ``chip_smoke.py``'s ``OPS_PER_PAIR``, ``HBM_BYTES_PER_S``,
``FP64_OPS_PER_S`` and ``bound_ms`` (the kernels of ``ipde_tpu_torch/csrc``):
later changes to the program do not move the yardstick.

FP64 operations per target-source pair, an FMA counted as 2 and a log,
sqrt or reciprocal as 1, counted from the first version of each kernel:

* laplace_slp: 2 sub, r^2 (mul + FMA), max, log, FMA accumulate (9);
* stokes_slp: 2 sub, r^2 (mul + FMA), max, reciprocal, log, mul, the force
  projection (mul + FMA + mul), two FMA pairs into u and v, add to p (22);
* laplace_grad: 2 sub, r^2 (mul + FMA), max, reciprocal, mul, two FMAs (12).

Bytes: every input read once and every output written once, 8 bytes a
number: S sources of (x, y and the kernel's charges), T targets of (x, y)
and the kernel's outputs.  Peaks: NVIDIA H100 SXM, 34 TFLOP/s in FP64
outside the tensor cores and 3.35 TB/s of HBM, both at the 700 W limit."""

HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
OPS_PER_PAIR = {"laplace_slp": 9, "stokes_slp": 22, "laplace_grad": 12}
# (numbers per source besides x and y, numbers out per target)
IN_OUT = {"laplace_slp": (1, 1), "stokes_slp": (2, 3), "laplace_grad": (1, 2)}


def bound_s(kernel, T, S):
    """(seconds, "operations" or "bytes"): the bound of one T x S sum."""
    n_in, n_out = IN_OUT[kernel]
    nbytes = 8 * ((2 + n_in) * S + (2 + n_out) * T)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_PAIR[kernel] * S * T / FP64_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def solve_bound_s(kernel, pairs):
    """The bound of one solve's sums: the sum over its (T, S) groups."""
    return sum(bound_s(kernel, T, S)[0] for T, S in pairs)
