"""Device milliseconds a step of HistoGAN's networks: the step's "mapping",
"G-fwd", "D-fwd" groups and their backward groups, and "copy/layout"
(counts/attribution.py, the model's RANGES), over the traced window. The
mapping group holds the mapping network and the histogram projection; the
path-length phase's synthesis runs under "G-fwd" and counts here, R1's
discriminator runs under "R1" and counts in histogan.reg_device_ms. A run
with no "mapping" group (a program without HistoGAN) reads nothing."""

UNIT, BETTER, LAYER = "ms", "lower", "HistoGAN networks (models/histogan.py)"
GROUPS = ("mapping", "mapping-bwd", "G-fwd", "G-bwd", "D-fwd", "D-bwd", "copy/layout")


def read(view):
    groups = view.groups()
    if not groups.get("mapping") or not view.steps:
        return None
    return 1e3 * sum(groups.get(g, 0.0) for g in GROUPS) / view.steps
