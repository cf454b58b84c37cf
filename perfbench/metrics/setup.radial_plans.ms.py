"""ms per moving step in the program's ``setup.radial_plans`` spans: the
stratified source-to-radial-grid plans of the solver's correction and of
the BIE (``ops/stratified.py``).  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.part_ms(rec, "setup.radial_plans")
