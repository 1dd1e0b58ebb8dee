"""Share of the traced window in which the device ran nothing: 100 x (1 -
the union of its kernels', copies' and memsets' intervals / the window)."""

UNIT, BETTER, LAYER = "%", "lower", "device"


def read(view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
