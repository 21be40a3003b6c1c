"""Share of the span pass's ``serve`` call in which no device event ran
while the innermost open program span was ``serve.forward`` (the host's
dispatch of a fold's TTA batches) or one inside it (``benchmark/spans.py``)."""
from benchmark import spans


def read(run):
    p = spans.of(run)
    return None if p is None else p.idle_share(["serve.forward"])
