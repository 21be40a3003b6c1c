"""Share of the span pass's epoch wall (``fit.epoch``) spent in
``fit.loss_read``: the host waiting on the card for each step's loss,
the time in which the card sets the pace (``benchmark/spans.py``)."""
from benchmark import spans


def read(run):
    p = spans.of(run)
    epochs = None if p is None else p.wall_in("fit.epoch")
    if not epochs:
        return None
    return 100.0 * p.wall_in("fit.loss_read") / epochs
