"""Device milliseconds a step of HistoGAN's optimizer: from the entry event
to the exit event of the program's "optimizer" spans (train/histogan.py:
torch Adam after each of Gmain, Greg, Dmain, Dreg, the gradients'
non-finite entries cleared first), summed over the traced window and
divided by its steps (counts/spans.py). A run whose program opens no "PL"
span (a program without HistoGAN) reads nothing."""

from benchmark.counts import spans

UNIT, BETTER, LAYER = "ms", "lower", "HistoGAN optimizer (torch.optim.Adam, train/histogan.py)"


def read(view):
    records = spans.in_window(view)
    if not any(s.name == "PL" for s in records):
        return None
    return spans.per_step(view, [s.device_ms() for s in records if s.name == "optimizer"])
