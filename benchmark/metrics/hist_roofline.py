"""The histogram loss's share of its roofline: the frozen least time of two
forwards and one backward a step (counts/histogram_work.py: products at
the chain dtype's tensor-core peak, taken once; elementwise at float32's;
bytes once) / the device time of the kernels the step's "hist-fwd" and
"hist-bwd" groups hold (counts/attribution.py), over the traced window,
at the model's image side (its SIDE). Each rank computes its own rows of
the batch."""

from benchmark.counts import histogram_work

UNIT, BETTER, LAYER = "%", "higher", "histogram loss (ops/histogram.py, ops/histogram_kernel.py)"


def read(view):
    groups = view.groups()
    measured = groups.get("hist-fwd", 0.0) + groups.get("hist-bwd", 0.0)
    if not measured or not view.steps:
        return None
    batch = view.cell.traffic["batch_size"] // view.world
    size = view.cell.config["settings"]["histogram_size"]
    hw = view.cell.model.SIDE ** 2
    floor = histogram_work.step_floor_seconds(batch, size, view.cell.dtype, hw) * view.steps
    return 100.0 * floor / measured
