"""ms per moving step in the program's ``planify.capture`` spans: a planified
call's capture after a replan miss (its eager warm-up and the recording of
its graphs); 0 where the traced steps captured nothing.  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.part_ms(rec, "planify.capture")
