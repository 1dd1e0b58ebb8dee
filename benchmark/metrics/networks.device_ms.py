"""Device milliseconds a step of the networks: the step's "G-fwd", "G-bwd",
"D-fwd", "D-bwd" and "copy/layout" groups (counts/attribution.py), over
the traced window."""

UNIT, BETTER, LAYER = "ms", "lower", "networks (models/networks.py)"
GROUPS = ("G-fwd", "G-bwd", "D-fwd", "D-bwd", "copy/layout")


def read(view):
    groups = view.groups()
    seconds = sum(groups.get(g, 0.0) for g in GROUPS)
    if not seconds or not view.steps:
        return None
    return 1e3 * seconds / view.steps
