"""Profiling and numerics-debugging helpers.

  - `trace`: a torch.profiler trace of a scope, written as a Chrome trace
    (chrome://tracing, Perfetto, TensorBoard's profiler plugin);
  - `device_step_seconds`: a step's device time, the summed durations of
    the kernels, copies and memsets the CUDA device ran, from the same
    profiler (`device_events` gives them one by one; `profile_step.py`
    prints them);
  - `marginal_step_seconds` / `marginal_call_seconds`: best-of-N marginal
    host clocks, (t_long - t_short) / (n_long - n_short), which cancel a
    fixed dispatch and fetch cost;
  - `StepTimer`: blocked host timing of steps;
  - `debug_nans`: anomaly detection over a scope.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _profiler_activities() -> list:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope on the host and, where there is one, the CUDA
    device; on exit write it as `log_dir/trace_<pid>_<ms>.json` (Chrome
    trace format). Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_profiler_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Anomaly detection within the scope: a backward function that returns
    NaN raises RuntimeError naming it, with the traceback of the forward op
    that made it. Unlike `jax_debug_nans`, which checks the outputs of
    every primitive as they are computed, this checks the backward pass: a
    NaN that a forward makes but no gradient sees goes through (check the
    losses for that), and a NaN gradient of a finite forward (a sqrt
    masked by a where) is caught."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def device_us(event) -> float:
    """An aggregate's own device time in microseconds, under the name this
    PyTorch version gives it."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def device_events(prof) -> list:
    """The device's own rows of a finished profile (kernels, copies,
    memsets), as key_averages() aggregates with device time. The host ops'
    rows and annotated ranges (the optimizer's step) are left out: they
    count the same device time again."""
    from torch.autograd import DeviceType

    return [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and device_us(e) > 0
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("Optimizer.")
    ]


def device_step_seconds(timed_fn, steps: int) -> float:
    """Seconds a step of device occupancy: `timed_fn(steps)` runs under
    torch.profiler, and the summed device time of the kernels, copies and
    memsets it made is divided by `steps`. The kernels of one stream do
    not overlap, so the sum is the time the device was busy; one device a
    process. Raises RuntimeError without a CUDA device or when nothing ran
    on it: a step time is never made up."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_step_seconds: PyTorch sees no CUDA device")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_profiler_activities()) as prof:
        timed_fn(steps)
        torch.cuda.synchronize()
    total_us = sum(device_us(e) for e in device_events(prof))
    if total_us <= 0:
        raise RuntimeError("device_step_seconds: the profile holds no device time")
    return total_us / 1e6 / steps


def marginal_step_seconds(timed_fn, steps: int, tries: int = 3) -> float | None:
    """Best-of-N host marginal seconds a step: `timed_fn(n)` runs n steps
    and returns its seconds; (t_full - t_short) / (steps - short) with
    short = steps // 4, the smallest positive of `tries` pairs. None when
    every marginal is non-positive (the caller decides what that means)."""
    short = max(steps // 4, 1)
    best = float("inf")
    for _ in range(tries):
        t_short = timed_fn(short)
        t_full = timed_fn(steps)
        marginal = (t_full - t_short) / (steps - short)
        if 0 < marginal < best:
            best = marginal
    return None if best == float("inf") else best


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def _force(out) -> None:
    """Wait for `out`: `.item()` of one element of its first tensor, or,
    with none, a synchronize of the current CUDA device."""
    leaf = _first_tensor(out)
    if leaf is not None:
        leaf.reshape(-1)[0].item()
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


def marginal_call_seconds(fn, args=(), n_long: int = 16, n_short: int = 4,
                          repeats: int = 3) -> float:
    """Best-of marginal seconds a `fn(*args)` call: n_short and n_long calls
    back to back, each run ended by a fetch of one element of the last
    output (or a synchronize of the CUDA device), the smallest positive
    (t_long - t_short) / (n_long - n_short) of `repeats` pairs, after 2
    warm-up calls."""

    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        _force(out)
        return time.perf_counter() - t0

    run(2)  # warm-up: cuDNN plans, the allocator, kernel builds
    best = float("inf")
    for _ in range(repeats):
        t_s = run(n_short)
        t_l = run(n_long)
        m = (t_l - t_s) / (n_long - n_short)
        if 0 < m < best:
            best = m
    return best


class StepTimer:
    """Blocked host-clock timing of steps: `stop(block_on)` fetches one
    element of `block_on` (a small output of the step, e.g. a loss) before
    it reads the clock, so the step's device work is inside the time."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, block_on=None):
        if block_on is not None:
            _force(block_on)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self, batch_size: int) -> dict:
        if not self.times:
            return {}
        mean = self.mean
        return {
            "mean_step_seconds": mean,
            "steps_per_second": 1.0 / mean,
            "images_per_second": batch_size / mean,
        }
