"""The traced window: torch.profiler over the window's first chunks, host
and device, and what the per-layer metrics read from it.

`Tracer` starts the profiler at the window's first chunk and stops it at
chunk `chunks` (or at the window's end), with a "bench.window" range
around the traced part. `View` is what a reader of metrics/ gets:
  * window_s: the traced window's length, from its range;
  * busy_s: the union of the intervals in which a kernel, copy or memset
    ran on the device, within the window (several streams counted once);
  * steps, images: the steps and images the traced window completed;
  * device_seconds(match), host_seconds(name), groups(): device seconds of
    the kernels whose name matches, host seconds of the CPU events of a
    name on the window's thread, and device seconds by the step's layers
    (counts/attribution.py on the ranges of the cell's model, built when
    first asked for);
  * breakdown(): the device ops that took most time and the longest idle
    gaps by what the host was doing.
"""

from __future__ import annotations

import collections

import torch

from ..counts.attribution import Attribution

WINDOW = "bench.window"
CPU = torch.autograd.DeviceType.CPU


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    def __init__(self, enabled: bool, chunks: int, device, step_of):
        self.enabled, self.chunks, self.device, self.step_of = enabled, chunks, device, step_of
        self.prof = None
        self.running = False
        self.steps = 0

    def at_chunk(self, i: int) -> None:
        if not self.enabled:
            return
        if i == 0 and self.prof is None:
            self._start()
        elif i == self.chunks and self.running:
            self._stop()

    def finish(self) -> None:
        if self.running:
            self._stop()

    def _start(self) -> None:
        _sync(self.device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        self.step0 = self.step_of()
        self.running = True

    def _stop(self) -> None:
        _sync(self.device)
        self.steps = self.step_of() - self.step0
        self.range.__exit__(None, None, None)
        self.prof.stop()
        self.running = False


def union_seconds(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def _gaps(intervals, start, end):
    out, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        out.append((cursor, end))
    return out


class View:
    """The traced window of one rank, with the cell and the window's counts."""

    def __init__(self, prof, cell, world: int, steps: int):
        self.prof, self.cell, self.world = prof, cell, world
        self.steps = steps
        self.images = steps * cell.traffic["batch_size"]
        events = prof.profiler.kineto_results.events()
        window = [e for e in events if e.device_type() == CPU and e.name() == WINDOW]
        if not window:
            raise RuntimeError("the profile holds no window range")
        self.start, self.end = window[0].start_ns(), window[0].start_ns() + window[0].duration_ns()
        self.thread = window[0].start_thread_id()
        self.window_s = (self.end - self.start) / 1e9
        self.device_rows = [
            (e.name(), max(e.start_ns(), self.start), min(e.start_ns() + e.duration_ns(), self.end))
            for e in events
            if e.device_type() != CPU and not e.is_user_annotation() and e.duration_ns() > 0
            and e.start_ns() < self.end and e.start_ns() + e.duration_ns() > self.start
        ]
        self.host_rows = [
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events
            if e.device_type() == CPU and e.start_thread_id() == self.thread and e.name() != WINDOW
        ]
        self.busy_s = union_seconds((s, e) for _, s, e in self.device_rows)
        self._groups = None

    def device_seconds(self, match) -> float:
        return sum(e - s for name, s, e in self.device_rows if match(name)) / 1e9

    def host_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.host_rows if n == name) / 1e9

    def groups(self) -> dict:
        """Device seconds of the traced window by the step's layer."""
        if self._groups is None:
            att = Attribution(self.prof, self.cell.model.RANGES)
            out = collections.Counter()
            lo, hi = (self.start - self.prof.profiler.kineto_results.trace_start_ns()) / 1e3, None
            hi = lo + self.window_s * 1e6
            for row in att.device_rows():
                if lo <= row.time_range.start < hi:
                    out[att.group(row)] += row.time_range.elapsed_us() / 1e6
            self._groups = dict(out)
        return self._groups

    def breakdown(self, top: int = 10) -> dict:
        ops = collections.Counter()
        for name, s, e in self.device_rows:
            ops[name[:120]] += (e - s) / 1e9
        gaps = _gaps([(s, e) for _, s, e in self.device_rows], self.start, self.end)
        by_host = collections.Counter()
        rows = sorted(self.host_rows, key=lambda r: (r[1], -r[2]))
        stack, i = [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            t = (s + e) // 2
            while i < len(rows) and rows[i][1] <= t:
                while stack and stack[-1][2] <= rows[i][1]:
                    stack.pop()
                stack.append(rows[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            if not stack:
                name = "(host between ops)"
            else:
                outer, inner = stack[0][0], stack[-1][0]
                name = outer if outer == inner else f"{outer} > {inner}"
            by_host[name[:120]] += (e - s) / 1e9
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}
