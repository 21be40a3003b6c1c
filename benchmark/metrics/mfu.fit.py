"""Model FLOPs of the window over the window and the bf16 dense peak
(989 TFLOP/s): 3 x the reference forward's FLOPs a 128x128 image for
each training image stepped (forward and backward), 1 x for each
validation image scored."""
from benchmark import costs


def read(run):
    f = run.facts
    if not f.get("trained_images"):
        return None
    per = run.config["forward_flops_per_image"]
    flops = per * (3 * f["trained_images"] + f["validated_images"])
    return 100.0 * flops / f["window_s"] / costs.BF16_DENSE_FLOPS
