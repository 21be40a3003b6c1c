"""Share of the traced serve call in which no device event ran: 100 x
(1 - the union of device intervals / the call's wall time)."""


def read(run):
    t = run.trace
    if t is None or not t.events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
