"""One span recorder for the train step and the Trainer's phases.

`span(name, ranged=True, **attrs)` marks a part of the work:
  * off (no profiler records and `enable()` was not called) it makes one
    check and returns a shared null context: it allocates nothing and
    records nothing;
  * on (a profiler records, or `enable(True)` was called) it keeps a
    `Span`: its name, its id, its parent's id, the id of the step it lies
    in, its host start and end from `time.time_ns()` (the clock of
    torch.profiler's events, so a reader can cut the records to a profiled
    window), its attributes and, once CUDA is in use, two CUDA events
    recorded on the current stream at its entry and its exit;
  * while a profiler records it also opens
    `torch.profiler.record_function(name)`, so a profile holds the ranges
    that roofline.py's attribution groups the kernels by; a span that
    holds the layers (a step, a Trainer phase) opens none with
    `ranged=False`, so that the innermost layer is the outermost host row
    a profile's idle gap is named by.

`mark_grad(record, tensor, name)` marks an open span where the gradient of
`tensor` is ready (a tensor hook, registered only while on): the generator
backward's "G-out", whose first part, in the indexed step, is the loss's
backward.

The spans (train/steps.py, train/trainer.py): "step" > the step's
layers "batch-gather", "augment", "G-fwd", "D-fwd", "hist-fwd", "loss",
"G-bwd", "D-bwd", "allreduce" (attribute "bytes": the gradients' all_reduce
bytes, from parallel/mesh.py::collectives), "optimizer"; and the Trainer's
phases "train_chunk", "scalar_logging", "preview", "discriminator_debug",
"evaluate_l1", "evaluate_fid", "checkpoint", at the top.

`records()` returns what was kept, in the order the spans opened, and
`clear()` drops it. The records are the caller's to clear: whoever turns
tracing on, or profiles, reads them and then clears them, or they stay for
the process's life. Device milliseconds (`Span.device_ms`, `Span.mark_ms`)
are read after the caller has synchronized; they are None without events.
`step_totals` and `phase_totals` fold records into milliseconds by span
name.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_enabled = False
_records: list[Span] = []
_ids = itertools.count(1)
_local = threading.local()  # this thread's open spans


def enable(flag: bool = True) -> None:
    """Record spans without a profiler (or stop, with False)."""
    global _enabled
    _enabled = flag


def records() -> list[Span]:
    """The spans kept since the last clear(), in the order they opened."""
    return list(_records)


def clear() -> None:
    _records.clear()


def _event():
    """A timing CUDA event recorded on the current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class Span:
    """One recorded span, its own context; `end_ns` is None while it is
    open."""

    __slots__ = ("name", "id", "parent", "step", "start_ns", "end_ns", "attrs", "events",
                 "marks", "ranged", "_range")

    def __init__(self, name: str, parent: Span | None, attrs: dict, ranged: bool):
        self.name, self.id, self.attrs, self.ranged = name, next(_ids), attrs, ranged
        self.parent = None if parent is None else parent.id
        self.step = self.id if name == "step" else (None if parent is None else parent.step)
        self.end_ns = self.events = self.marks = None

    def __enter__(self) -> Span:
        # the range first: the record's host interval then lies inside it
        self._range = record_function(self.name) if self.ranged and _profiler_enabled() else None
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            self.events = [_event()]
        _records.append(self)
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        if self.events is not None:
            self.events.append(_event())
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    def mark(self, name: str) -> None:
        """The host time and, with events, a CUDA event of a point inside."""
        event = None if self.events is None else _event()
        if self.marks is None:
            self.marks = {}
        self.marks[name] = (time.time_ns(), event)

    @property
    def host_ms(self) -> float | None:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> float | None:
        """Device milliseconds from the entry event to the exit event."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])

    def mark_ms(self, name: str) -> float | None:
        """Device milliseconds from the entry event to mark `name`."""
        if self.events is None or not self.marks or name not in self.marks:
            return None
        return self.events[0].elapsed_time(self.marks[name][1])


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, ranged: bool = True, **attrs):
    """A context that records the span `name` while on (yields its `Span`),
    the shared null context (yields None) while off."""
    if not (_enabled or _profiler_enabled()):
        return _NULL
    stack = _stack()
    return Span(name, stack[-1] if stack else None, attrs, ranged)


def mark_grad(record: Span | None, tensor: torch.Tensor, name: str) -> None:
    """Mark `record` as `name` when the gradient of `tensor` is ready; no
    hook when `record` is None (off)."""
    if record is not None:
        tensor.register_hook(lambda grad: record.mark(name))


def _add(totals: dict, name: str, host_ms: float, device_ms: float | None) -> None:
    t = totals.setdefault(name, {"device_ms": None, "host_ms": 0.0, "count": 0})
    t["host_ms"] += host_ms
    t["count"] += 1
    if device_ms is not None:
        t["device_ms"] = (t["device_ms"] or 0.0) + device_ms


def step_totals(spans, totals: dict | None = None) -> dict:
    """The closed spans that lie in a step (the steps included) folded into
    `totals`: name -> {"device_ms", "host_ms", "count"}, and "<name> to
    <mark>" for the part of a span before each of its marks; "device_ms"
    stays None without events. Synchronize first."""
    totals = {} if totals is None else totals
    for s in spans:
        if s.step is None or s.end_ns is None:
            continue
        _add(totals, s.name, s.host_ms, s.device_ms())
        for mark, (at_ns, _) in (s.marks or {}).items():
            _add(totals, f"{s.name} to {mark}", (at_ns - s.start_ns) / 1e6, s.mark_ms(mark))
    return totals


def phase_totals(spans, totals: dict | None = None) -> dict:
    """The closed spans at the top (no parent: the Trainer's phases) folded
    into `totals` as step_totals folds a step's. Synchronize first."""
    totals = {} if totals is None else totals
    for s in spans:
        if s.parent is None and s.end_ns is not None:
            _add(totals, s.name, s.host_ms, s.device_ms())
    return totals
