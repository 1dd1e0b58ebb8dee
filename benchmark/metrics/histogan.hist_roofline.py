"""HistoGAN's histograms' share of their roofline: the frozen least time
of two forwards (the reals', the fakes') and one backward (the fakes') a
step at the histogram's pixels (counts/histogram_work.py; 22,500 at a
150x150 resize) / the device time of the kernels of the step's "hist-fwd"
and "hist-bwd" groups (counts/attribution.py: K3b, K4b and their
prologue: clamp, resize, logs, the pad), over the traced window. A
configuration without the histogram's resize (not HistoGAN's) reads
nothing."""

from benchmark.counts import histogram_work

UNIT, BETTER, LAYER = "%", "higher", "histogram loss (ops/histogram.py, ops/histogram_kernel.py)"


def read(view):
    s = view.cell.config.get("settings", {})
    if "histogram_resize" not in s:
        return None
    groups = view.groups()
    measured = groups.get("hist-fwd", 0.0) + groups.get("hist-bwd", 0.0)
    if not measured or not view.steps:
        return None
    side = min(s["resolution"], s["histogram_resize"])
    batch = view.cell.traffic["batch_size"] // view.world
    floor = histogram_work.step_floor_seconds(batch, s["histogram_size"], view.cell.dtype,
                                              side * side) * view.steps
    return 100.0 * floor / measured
