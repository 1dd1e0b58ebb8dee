"""The indexed losses' share of their bytes floor: the (B, 64, 64, 256)
logits in the compute dtype read once forward, read once and their
gradient written once backward, the int32 labels read once a pass, at
3.35 TB/s / the device time of the step's "loss" and "loss-bwd" groups
(counts/attribution.py), over the traced window. The patch BCE terms
(under 0.1% of the bytes) are left out of the floor."""

from benchmark.counts.peaks import PEAK

UNIT, BETTER, LAYER = "%", "higher", "indexed losses (train/losses.py)"
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(view):
    groups = view.groups()
    measured = groups.get("loss", 0.0) + groups.get("loss-bwd", 0.0)
    if not measured or not view.steps:
        return None
    batch = view.cell.traffic["batch_size"] // view.world
    pixels = batch * 64 * 64
    classes = view.cell.config["network"]["generator_out_channels"]
    moved = 3 * pixels * classes * ITEMSIZE[view.cell.dtype] + 2 * pixels * 4
    return 100.0 * moved / PEAK["bytes"] * view.steps / measured
