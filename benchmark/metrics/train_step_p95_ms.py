"""The 95th percentile of every training step's wall in the window
(from the epoch's start or the step before to the step's end, through
the fit loop's callback hooks); the run's stderr gives its count."""


def read(run):
    return run.facts.get("train_step_p95_ms")
