"""% of the time inside the program's ``setup.*`` spans during which the device
was busy (the trace's busy intervals, on the same clock): low where set-up
waits on the host.  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.busy_pct(rec, "setup")
