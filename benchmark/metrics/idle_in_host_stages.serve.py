"""Share of the span pass's ``serve`` call in which no device event ran
while the innermost open program span was one of the host stages around
the model, or one inside them: ``serve.restore``, ``serve.decode``,
``serve.upload``, ``serve.download``, ``serve.submission``,
``serve.provenance`` (``benchmark/spans.py``)."""
from benchmark import spans

STAGES = ("serve.restore", "serve.decode", "serve.upload", "serve.download",
          "serve.submission", "serve.provenance")


def read(run):
    p = spans.of(run)
    return None if p is None else p.idle_share(STAGES)
