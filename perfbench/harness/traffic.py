"""The one traffic generator: it reads a mix's parameters and makes, from
the seed, every call of a run.

One caller makes the calls in a closed loop, each once the last one's
output is ready.  A mix (``traffic/<name>.json``) gives:

* ``rhs_bank``: right-hand sides drawn in set-up and cycled through, and
  ``forcing``: the equation's ``draw`` parameters (its wave numbers);
* ``turn_rad``: each call turns the boundary by an angle drawn uniformly in
  [-turn_rad, turn_rad] about the set-up geometry and rebuilds the problem
  on it (0: the boundary never moves, and the call is a solve alone), and
  ``pad_quantum``: the quantum that every boundary position is registered
  with, so that its plan shapes stay (``advection/stepper.py`` asks for
  one; absent: no padding, as ``generate_grid(h)``);
* ``warm_calls``: calls made in set-up, before the window, ``trace_calls``:
  calls traced after it with ``--trace 1``, ``samples``: outputs of the
  window, drawn from the seed, that are held to the reference.

The same seed gives the same right-hand sides, angles and samples."""

import numpy as np


class Schedule:
    def __init__(self, traffic, equation, seed):
        rng = np.random.default_rng([seed, 0])
        self.bank = [equation.draw(rng, traffic["forcing"])
                     for _ in range(int(traffic["rhs_bank"]))]
        self.turn = float(traffic.get("turn_rad", 0.0))
        self.moves = self.turn > 0.0
        self._turns = np.random.default_rng([seed, 1])
        self._pick = np.random.default_rng([seed, 2])
        self.samples = int(traffic["samples"])
        self.kept = []

    def rhs(self, i):
        """The bank index of call ``i``."""
        return i % len(self.bank)

    def rot(self):
        """The next call's angle (0 for a mix that does not move)."""
        if not self.moves:
            return 0.0
        return float(self._turns.uniform(-self.turn, self.turn))

    def keep(self, i, item):
        """Reservoir sampling: after call ``i`` (0-based) ``kept`` holds a
        uniform draw of ``samples`` of the calls so far."""
        if len(self.kept) < self.samples:
            self.kept.append(item)
            return
        j = int(self._pick.integers(0, i + 1))
        if j < self.samples:
            self.kept[j] = item
