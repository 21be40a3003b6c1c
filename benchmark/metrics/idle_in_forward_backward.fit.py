"""Share of the span pass's ``fit`` call in which no device event ran
while the innermost open program span was ``fit.augment``,
``fit.forward`` or ``fit.backward``, or one inside them
(``benchmark/spans.py``)."""
from benchmark import spans


def read(run):
    p = spans.of(run)
    return None if p is None else p.idle_share(
        ["fit.augment", "fit.forward", "fit.backward"])
