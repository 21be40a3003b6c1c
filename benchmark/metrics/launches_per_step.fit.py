"""Kernel launches (the CUDA API's ``*LaunchKernel*`` calls) made inside
the span pass's ``fit.step`` spans, over their number: launches a
training step (``benchmark/spans.py``)."""
from benchmark import spans


def read(run):
    p = spans.of(run)
    steps = None if p is None else len(p.record.named("fit.step"))
    if not steps:
        return None
    return p.launches_in("fit.step") / steps
