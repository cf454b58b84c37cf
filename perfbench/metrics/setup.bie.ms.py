"""ms per moving step in the program's ``setup.bie`` spans (with
``setup.bie.invert``, the inverse of the BIE system), less the QFS maps and
evaluators built inside them.  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.part_ms(rec, "setup.bie")
