"""Device milliseconds a step of HistoGAN's lazy regularizers: from the
entry event to the exit event of the program's "PL" and "R1" spans
(train/histogan.py: each phase's forward, first-order gradient and
backward, its optimizer step outside), summed over the traced window and
divided by its steps (counts/spans.py). A program without those spans
reads nothing."""

from benchmark.counts import spans

UNIT, BETTER, LAYER = "ms", "lower", "regularizers (train/histogan.py)"


def read(view):
    return spans.per_step(view, [s.device_ms() for s in spans.in_window(view)
                                 if s.name in ("PL", "R1")])
