"""One reader per metric, found by the metric's name in BENCHMARK.json.

Each file defines ``read(rec)`` of a ``harness.main.Record`` and returns the
metric's value, or None where the run holds nothing to read (the harness
then leaves the metric out of the line)."""
