"""ms per moving-boundary step in the benchmark's span around building the solver and its BIE on the moved boundary (QFS maps, BIE inverse, evaluator tables), ended by synchronize."""


def read(rec):
    v = rec.spans.get("setup")
    return 1e3 * sum(v) / len(v) if v else None
