"""The program's own span records (palette_and_histo_gan_tpu_torch/
utils/tracing.py) in the traced window, for the metrics read from the
program: its spans record while the profiler records and stamp their host
times with time.time_ns(), the profiler's clock, so the window's records
are those whose host interval lies inside the "bench.window" range. A
program without the recorder gives none; this process's records are rank
0's under data parallelism."""

from __future__ import annotations


def in_window(view, events: bool = True) -> list:
    """The closed spans inside the traced window; with `events`, only those
    that recorded CUDA events (none on the CPU)."""
    try:
        from palette_and_histo_gan_tpu_torch.utils import tracing
    except ImportError:
        return []
    return [s for s in tracing.records()
            if s.end_ns is not None and view.start <= s.start_ns and s.end_ns <= view.end
            and (s.events is not None or not events)]


def per_step(view, values: list) -> float | None:
    """The sum of `values` a step of the window; None without values."""
    if not values or None in values or not view.steps:
        return None
    return sum(values) / view.steps
