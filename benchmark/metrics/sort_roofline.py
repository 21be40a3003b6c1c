"""Row 2 (``bitonic_sort_*`` kernels): the bound of one call (batch rows
x 32,768 fp32 keys with an int32 payload, read and written once; the
network's compare-exchanges at the fp32 rate) over the kernels' device
time per call of the traced epoch (a call a training step and a call a
validation batch)."""
from benchmark import costs, trace


def read(run):
    t = run.trace
    if t is None:
        return None
    ms = trace.per_call_ms(t.events, t.calls["sort_calls"], "bitonic_sort_")
    if not ms:
        return None
    return 100.0 * costs.sort_s(run.facts["batch"], 2 * 128 * 128) * 1e3 / ms
