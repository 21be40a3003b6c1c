"""Share of the span pass's ``fit`` call (an epoch and its validation) in
which no device event ran while the innermost open program span was
``fit.optimizer`` (Adam's step) or one inside it (``benchmark/spans.py``)."""
from benchmark import spans


def read(run):
    p = spans.of(run)
    return None if p is None else p.idle_share(["fit.optimizer"])
