"""Device milliseconds a step of the indexed losses (ops/indexed_loss.py, the
CCE-fwd and CCE-bwd kernel pair, under train/losses.py), from the program's
spans (counts/spans.py): the "loss" spans (the forward terms, D's loss, the
chunk's metrics) plus each "G-bwd" span from its entry event to its mark
"G-out", where the gradient of G's logits is ready (the CCE's and the
one-hot L1's backward; D runs without a graph in the indexed step), over
the traced window. A configuration with a softmax head only: in an RGBA
step that part of "G-bwd" also holds D's and the histogram's backward.
LAYER is the layer's name in BENCHMARK.json, letter for letter."""

from benchmark.counts import spans

UNIT, BETTER, LAYER = "ms", "lower", "indexed losses (train/losses.py)"


def read(view):
    if view.cell.config.get("network", {}).get("head") != "softmax":
        return None
    recorded = spans.in_window(view)
    forward = [s.device_ms() for s in recorded if s.name == "loss"]
    backward = [s.mark_ms("G-out") for s in recorded if s.name == "G-bwd"]
    if not forward or not backward:
        return None
    return spans.per_step(view, forward + backward)
