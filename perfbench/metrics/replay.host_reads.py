"""Host reads of GMRES status per solve in the window
(``LockstepGmres.host_reads``, a counter of the program)."""


def read(rec):
    n = rec.counters.get("completed", 0)
    return rec.counters["host_reads"] / n if n else None
