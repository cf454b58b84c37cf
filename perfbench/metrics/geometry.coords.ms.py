"""ms per moving step in the program's ``geometry.coords`` spans: each boundary's
near grid points and their (t, r) (``EmbeddedBoundary.register_grid``,
``native/coords.cpp``).  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.part_ms(rec, "geometry.coords")
