"""Model FLOPs of the window's served image-folds over the window and
the bf16 dense peak (989 TFLOP/s): the reference forward's FLOPs a
128x128 image (``forward_flops_per_image``) x 2 hflip TTA passes x the
image-folds served. The int8 cell is held to the same bf16 peak."""
from benchmark import costs


def read(run):
    f = run.facts
    if not f.get("image_folds"):
        return None
    flops = run.config["forward_flops_per_image"] * 2 * f["image_folds"]
    return 100.0 * flops / f["window_s"] / costs.BF16_DENSE_FLOPS
