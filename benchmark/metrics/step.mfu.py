"""The whole train step's share of the cards' peak: the FLOP count an image
of the cell's model (its flops_per_image; pix2pix's is counts/flops.py) x
the images the traced window completed / (its seconds x the chips x the
peak of the compute dtype: 989 TFLOP/s bfloat16, 67 TFLOP/s float32, which
runs with TF32 off)."""

from benchmark.counts.peaks import PEAK

UNIT, BETTER, LAYER = "%", "higher", "train step (train/steps.py)"


def read(view):
    if not view.images:
        return None
    per_image = view.cell.model.flops_per_image(view.cell.config)
    peak = PEAK["bfloat16" if view.cell.dtype == "bfloat16" else "float32"]
    return 100.0 * per_image * view.images / (view.window_s * view.world * peak)
