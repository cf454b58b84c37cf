"""The share of its roofline that a layer-potential kernel reaches in one
solve, shared by the ``<kernel>_roofline`` readers.

Work: the configuration's ``slp_pairs_per_solve``, the (targets, sources)
of every sum one solve needs on the fft path (the interface targets against
the QFS sources, and the radial groups), counted from its shapes.  Bound:
``harness/roofline.py`` (FP64 34 TFLOP/s, 3.35 TB/s).  Time: the traced
device time of the kernel and of the split-sum combine kernel that
finishes its launches, per solve.  None where the trace holds none of the
kernel's time, or the configuration runs another kernel."""

from perfbench.harness.roofline import solve_bound_s

COMBINE = "combine_splits_kernel"


def share(rec, kernel):
    if rec.trace is None or rec.cfg.get("kernel") != kernel:
        return None
    busy = rec.trace.kernel_s([f"{kernel}_kernel", COMBINE]) / rec.trace.calls
    if busy <= 0.0:
        return None
    return 100.0 * solve_bound_s(kernel, rec.cfg["slp_pairs_per_solve"]) \
        / busy
