"""Row 1 (``preprocess_inference_kernel``): its bound over its device
time per forward of the traced call. The bound is the batch's bytes
(2 x batch images for hflip TTA: uint8 101x101 in, bf16 128x128x3 out)."""
from benchmark import costs, trace


def read(run):
    t = run.trace
    if t is None:
        return None
    ms = trace.per_call_ms(t.events, t.calls["forwards"],
                           "preprocess_inference_kernel")
    if not ms:
        return None
    return 100.0 * costs.preprocess_s(2 * run.facts["batch"]) * 1e3 / ms
