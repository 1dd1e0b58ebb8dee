"""The indexed losses' share of their bytes floor (ops/indexed_loss.py, the
CCE-fwd and CCE-bwd kernel pair, under train/losses.py): the (B, side,
side, 256) logits in the compute dtype read once forward, read once and
their gradient written once backward, the int32 labels read once a pass,
at 3.35 TB/s / the device time of the step's "loss" and "loss-bwd" groups
(counts/attribution.py), over the traced window; the side is the model's
(its SIDE). The patch BCE terms (under 0.1% of the bytes) are left out of
the floor. LAYER is the layer's name in BENCHMARK.json, letter for
letter."""

from benchmark.counts.peaks import PEAK

UNIT, BETTER, LAYER = "%", "higher", "indexed losses (train/losses.py)"
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(view):
    groups = view.groups()
    measured = groups.get("loss", 0.0) + groups.get("loss-bwd", 0.0)
    if not measured or not view.steps:
        return None
    batch = view.cell.traffic["batch_size"] // view.world
    pixels = batch * view.cell.model.SIDE ** 2
    classes = view.cell.config["network"]["generator_out_channels"]
    moved = 3 * pixels * classes * ITEMSIZE[view.cell.dtype] + 2 * pixels * 4
    return 100.0 * moved / PEAK["bytes"] * view.steps / measured
