"""Profiling and numerics-debugging helpers.

  - `device_step_seconds`: a step's device time, the summed durations of
    the kernels, copies and memsets the CUDA device ran, from
    torch.profiler (`device_events` gives them one by one;
    `profile_step.py` prints them);
  - `marginal_step_seconds` / `marginal_call_seconds`: best-of-N marginal
    host clocks, (t_long - t_short) / (n_long - n_short), which cancel a
    fixed dispatch and fetch cost;
  - `debug_nans`: anomaly detection over a scope;
  - `card_line`: the card's name and power limit, as nvidia-smi gives
    them, which every measurement prints beside its numbers;
  - `write_build_json`: the measurement tools' JSON, written only under
    the working directory's `build/`.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time

import torch

from . import tracing


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


def device_seconds(prof) -> float:
    """The summed device time, in seconds, of a finished profile's kernels,
    copies and memsets: device_events' rows (device rows that are not an
    annotated range), read from the profile's raw events without building
    its host-side event list (seconds of Python for a chunk's profile)."""
    from torch.autograd import DeviceType

    return sum(
        raw.duration_ns() for raw in prof.profiler.kineto_results.events()
        if raw.device_type() != DeviceType.CPU and not raw.is_user_annotation()
        and not raw.name().startswith("Optimizer.")
    ) / 1e9


def device_step_seconds(timed_fn, steps: int) -> float:
    """Seconds a step of device occupancy: `timed_fn(steps)` runs under
    torch.profiler, and the summed device time of the kernels, copies and
    memsets it made (device_seconds) is divided by `steps`. The kernels of
    one stream do not overlap, so the sum is the time the device was busy;
    one device a process. Only the device's activity is recorded: the
    host's op rows count no device time. Raises RuntimeError without a
    CUDA device or when nothing ran on it: a step time is never made up."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_step_seconds: PyTorch sees no CUDA device")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        timed_fn(steps)
        torch.cuda.synchronize()
    tracing.clear()  # the spans the profile recorded: its rows hold what is read
    total = device_seconds(prof)
    if total <= 0:
        raise RuntimeError("device_step_seconds: the profile holds no device time")
    return total / steps


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


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def write_build_json(path: str, obj) -> str:
    """Write `obj` as JSON to `path`, which must lie under `build/` of the
    working directory (which .gitignore lists), so that no measurement
    overwrites a file of the repository; returns the absolute path."""
    build = os.path.realpath("build")
    out = os.path.realpath(path)
    if os.path.commonpath([build, out]) != build or out == build:
        raise ValueError(f"{path!r}: the measurement tools write only under {build}")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(obj, f, indent=1)
    return out
