"""Device milliseconds a step of the NCCL all_reduce kernels on rank 0 (the
two gradient all_reduces a step, train/steps.py::_average_gradients, and
the metrics' one a chunk), over the traced window."""

UNIT, BETTER, LAYER = "ms", "lower", "data parallel (parallel/dp.py)"


def read(view):
    if view.world < 2 or not view.steps:
        return None
    seconds = view.device_seconds(lambda n: "nccl" in n.lower() and "allreduce" in n.lower())
    return 1e3 * seconds / view.steps if seconds else None
