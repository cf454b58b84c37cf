"""``mh_slp``'s share of its roofline per solve: the least time the card
could take for the Yukawa single-layer sums of one solve, over their traced
device time.

Work: the configuration's ``slp_pairs_per_solve`` (the (targets, sources)
of every ``mh_slp`` launch of one planified solve + ``apply_bc``) at a
frozen 82 FP64 operations a pair, an FMA counted as 2 and a log, sqrt,
exp or reciprocal as 1.  That is the series branch of K0 in the first
``csrc/mh_slp.cu`` (``chip_smoke.py``'s ``MH_OPS_PER_PAIR``): 2 sub, r^2
(mul + FMA), max, sqrt, mul by k, the compare z < 2 and the FMA accumulate
(11), then q (mul), 13 terms of (2 mul, add, FMA), log and 2 FMA (71).  The
Chebyshev branch (2 <= z <= 36) costs 98 and a dead pair (z > 36) 12; at
k = 2 every pair of a unit-size boundary has z < 36, so 82 is at most each
pair's count, and the share cannot pass 100% whatever sums the pairs.
Bytes: every input read once and every output written once, 8 bytes a
number: S sources of (x, y, charge), T targets of (x, y) and one output.
Peaks: ``harness/roofline.py``'s.  Time: the traced device time of
``mh_slp_kernel`` and of the split-sum combine kernel that finishes its
launches, per solve.  None where the trace holds none of that time, or the
configuration runs another kernel."""

from perfbench.harness.roofline import FP64_OPS_PER_S, HBM_BYTES_PER_S

KERNEL = "mh_slp"
OPS_PER_PAIR = 82
NAMES = ("mh_slp_kernel", "combine_splits_kernel")


def bound_s(T, S):
    """(seconds, "operations" or "bytes"): the bound of one T x S sum."""
    t_bytes = 8 * (3 * S + 3 * T) / HBM_BYTES_PER_S
    t_ops = OPS_PER_PAIR * S * T / FP64_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def solve_bound_s(pairs):
    """The bound of one solve's sums: the sum over its (T, S) groups."""
    return sum(bound_s(T, S)[0] for T, S in pairs)


def read(rec):
    if rec.trace is None or rec.cfg.get("kernel") != KERNEL:
        return None
    busy = rec.trace.kernel_s(list(NAMES)) / rec.trace.calls
    if busy <= 0.0:
        return None
    return 100.0 * solve_bound_s(rec.cfg["slp_pairs_per_solve"]) / busy
