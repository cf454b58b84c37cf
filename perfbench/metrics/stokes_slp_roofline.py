"""``stokes_slp``'s share of its roofline per solve (see ``_slp_roofline.py``)."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_slp_roofline.py"), "metric")


def read(rec):
    return _shared.share(rec, "stokes_slp")
