"""Share of the window spent between an epoch's last step and its end:
the validation pass (predict, the 21-threshold sweep, the validation
loss)."""


def read(run):
    f = run.facts
    if not f.get("window_s"):
        return None
    return 100.0 * f["validation_s"] / f["window_s"]
