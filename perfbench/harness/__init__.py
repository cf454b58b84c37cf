"""The general parts of the benchmark: finding a cell's files by name
(``spec.py``), the program under test (``problem.py``, ``planstep.py``),
the one traffic generator (``traffic.py``), the measured window
(``window.py``), the profiler's trace (``trace.py``), the roofline's
arithmetic (``roofline.py``), the output check (``check.py``) and the run
itself (``main.py``)."""
