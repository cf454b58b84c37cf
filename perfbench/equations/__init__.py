"""Seeded manufactured solutions, one file per equation.

Each file gives, for the equation that a configuration's ``equation`` key
names:

* ``FORCING`` and ``BOUNDARY``: how many forcing and boundary-data
  components the solve takes, in order;
* ``FIELDS``: the output fields in the order the solve returns them, and
  ``MEAN_FREE``: the fields that are defined up to a constant;
* ``CHECKS``: the names of the numbers compared, each the largest of the
  absolute errors of ``FIELDS`` it groups;
* ``draw(rng, spec)``: one right-hand side's parameters, from a
  ``numpy.random.Generator``, as plain floats;
* ``forcing(p, x, y, xp)`` and ``boundary(p, x, y, xp)``: the data handed
  to the program, evaluated with the array module ``xp`` (``torch`` on the
  card in set-up, ``numpy`` in the tests);
* ``exact(p, x, y, dtype)``: the solution, by plain NumPy in ``dtype``:
  the reference that the program's output is held to.

The solutions are sums of plane waves whose wave numbers are the same for
every seed (``spec["k"]``); the seed draws their directions, phases and
signs, so every seed asks the same work of the solver.
"""
