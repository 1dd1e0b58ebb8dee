"""Device milliseconds a step from the end of D's backward to the end of
the gradient exchange, on rank 0, from the program's spans
(counts/spans.py): the exit event of each step's "D-bwd" span to the exit
event of its "allreduce" span (train/steps.py::_average_gradients: the
flatten, the NCCL all_reduces, the unflatten copies), over the traced
window. A change that overlaps the exchange with the backward leaves only
its exposed part here."""

from benchmark.counts import spans

UNIT, BETTER, LAYER = "ms", "lower", "data parallel (parallel/dp.py)"


def read(view):
    if view.world < 2:
        return None
    recorded = spans.in_window(view)
    d_bwd = {s.step: s for s in recorded if s.name == "D-bwd"}
    return spans.per_step(view, [d_bwd[s.step].events[1].elapsed_time(s.events[1])
                                 for s in recorded
                                 if s.name == "allreduce" and s.step in d_bwd])
