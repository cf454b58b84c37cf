"""ms per solve in the program's ``gmres.read`` spans: the host's waits for the
GMRES status reads of the replay.  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.span_ms(rec, "gmres.read")
