"""The plain reference: NumPy only.  It imports nothing of the program and
takes nothing the program made: it works the geometry out again from the
configuration (``geometry.py``) and evaluates each equation's solution
(``perfbench/equations``) there, and ``compare.py`` holds the program's
output to it."""
