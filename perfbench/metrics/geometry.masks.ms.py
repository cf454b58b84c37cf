"""ms per moving step in the program's ``geometry.masks`` spans: the inside,
physical and annulus masks, the padded point sets, the step function, their
device copies and the box's Fourier operators (``register_grid``).  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.part_ms(rec, "geometry.masks")
