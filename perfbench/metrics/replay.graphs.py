"""CUDA graphs replayed per solve (the program's ``planify.graphs`` counter):
3 + the GMRES chunks + the cycle ends of each loop.  See ``_program_spans.py``."""

from pathlib import Path

from perfbench.harness.spec import load_module

_shared = load_module(Path(__file__).with_name("_program_spans.py"), "metric")


def read(rec):
    return _shared.per_call(rec, "planify.graphs")
