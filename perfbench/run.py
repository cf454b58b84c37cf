"""Run one cell of the benchmark of ``ipde_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json`` (``harness/spec.py``).
The run sets up the cell's problem on the first CUDA card from the
configuration file, draws its inputs from the seed, captures the planified
solve and warms the cell's own calls (all of which is ``setup_s``), then
makes calls in a closed loop for ``--seconds``.  With ``--trace 0`` it
reports the cell's end-to-end metrics; with ``--trace 1`` it traces a few
more calls with torch.profiler and reports the per-layer metrics,
``busy_s``, ``window_s`` and ``breakdown``.  Then it frees the program's
state and holds a seeded sample of the window's outputs to the plain NumPy
reference (``reference/``), prints each number compared beside its limit
as the last lines of standard error, and prints one JSON line last on
standard output.  It exits non-zero, and prints no result, without enough
cards, and when a module of JAX or of the JAX package is loaded."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
