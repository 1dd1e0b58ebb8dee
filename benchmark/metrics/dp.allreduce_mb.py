"""Megabytes (1e6 bytes) a step that the gradient exchange all_reduces on
rank 0: the attribute "bytes" of the program's "allreduce" spans
(train/steps.py::_average_gradients, counted by parallel/mesh.py), over
the traced window (counts/spans.py). A counter: it needs no events."""

from benchmark.counts import spans

UNIT, BETTER, LAYER = "MB", "lower", "data parallel (parallel/dp.py)"


def read(view):
    if view.world < 2:
        return None
    return spans.per_step(view, [s.attrs["bytes"] / 1e6 for s in spans.in_window(view, False)
                                 if s.name == "allreduce" and "bytes" in s.attrs])
