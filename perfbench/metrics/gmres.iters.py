"""Annular GMRES iterations per solve in the window: the solve's own
``annular_iterations``, summed over its boundaries."""


def read(rec):
    n = rec.counters.get("completed", 0)
    return rec.counters["gmres_iters"] / n if n else None
