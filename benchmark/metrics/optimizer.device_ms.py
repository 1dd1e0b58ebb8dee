"""Device milliseconds a step of the optimizer: from the entry event to the
exit event of the program's "optimizer" spans (train/steps.py: both
KerasAdam steps, the idle between their kernels included), over the traced
window (counts/spans.py)."""

from benchmark.counts import spans

UNIT, BETTER, LAYER = "ms", "lower", "optimizer (train/state.py::KerasAdam)"


def read(view):
    return spans.per_step(view, [s.device_ms() for s in spans.in_window(view)
                                 if s.name == "optimizer"])
