"""Kernel launches (the CUDA API's ``*LaunchKernel*`` calls) made inside
the span pass's ``serve.forward`` spans, over the program's counter
``serve.forwards``: launches a TTA batch forward (``benchmark/spans.py``)."""
from benchmark import spans


def read(run):
    p = spans.of(run)
    forwards = None if p is None else p.record.counters.get("serve.forwards")
    if not forwards:
        return None
    return p.launches_in("serve.forward") / forwards
