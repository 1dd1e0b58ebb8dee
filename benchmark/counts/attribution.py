"""Which layer of the step each kernel of a profile belongs to: a frozen
copy of palette_and_histo_gan_tpu_torch/roofline.py's attribution.

  * a forward kernel takes the innermost named range of the op that
    launched it (the op around the runtime call with the kernel's
    correlation id, else the op its linked correlation id names); the
    ranges are the ones the program's spans (utils/tracing.py::span) open
    while a profiler records: pix2pix's train step's by default (RANGES),
    the cell's model's in a run (models/<model>.py, its RANGES);
  * a backward kernel takes the "-bwd" group of the forward op whose
    autograd node ran it: the profiler's sequence number ties an
    `autograd::engine::evaluate_function` row to the last forward op that
    recorded it;
  * layout kernels go to "copy/layout" whatever their range: a same-dtype
    `aten::copy_` under `aten::contiguous`, `aten::clone` or
    `aten::reshape`, and cuDNN's layout transforms (LAYOUT_KERNELS);
  * what is left goes to "unattributed".
"""

from __future__ import annotations

import torch

RANGES = ("batch-gather", "augment", "G-fwd", "D-fwd", "hist-fwd", "loss", "optimizer")
LAYOUT = "copy/layout"
UNATTRIBUTED = "unattributed"
EVALUATE = "autograd::engine::evaluate_function"
LAYOUT_PARENTS = ("aten::contiguous", "aten::clone", "aten::reshape")
LAYOUT_KERNELS = ("nchwtonhwc", "nhwctonchw", "transpose_readwrite", "tensortransform")
CPU = torch.autograd.DeviceType.CPU


def backward_group(group: str) -> str:
    """"G-fwd" -> "G-bwd", "loss" -> "loss-bwd"."""
    return group[:-len("-fwd")] + "-bwd" if group.endswith("-fwd") else group + "-bwd"


def ancestors(event):
    while event is not None:
        yield event
        event = event.cpu_parent


def is_runtime(event) -> bool:
    """A call of the CUDA API on the host (cudaLaunchKernel, cuLaunchKernelEx)."""
    name = event.name
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn") and (
        name[2:3].isupper() or name[4:5].isupper())


def _call(obj, *names, default=None):
    for name in names:
        if hasattr(obj, name):
            return getattr(obj, name)()
    return default


class Attribution:
    """Groups of a finished profile's ops and device rows."""

    def __init__(self, prof, ranges=RANGES):
        self.ranges = tuple(ranges)
        results = prof.profiler.kineto_results
        start = results.trace_start_ns()
        # what a FunctionEvent of some PyTorch versions lacks: each device
        # row's linked correlation id, each op's input dtypes
        self.linked, self.dtypes = {}, {}
        for k in results.events():
            if k.device_type() == CPU:
                self.dtypes[k.correlation_id()] = _call(k, "dtypes", default=[])
            else:
                self.linked[(k.correlation_id(), k.start_ns() - start)] = k.linked_correlation_id()
        self.events = prof.events()
        cpu = [e for e in self.events if e.device_type == CPU]
        self.cpu = cpu
        self.ops = {e.id: e for e in cpu if not is_runtime(e)}
        self.runtime = {e.id: e for e in cpu if is_runtime(e)}
        self.forward = {}
        for e in sorted(cpu, key=lambda e: e.time_range.start):
            if e.sequence_nr >= 0 and not any(a.name.startswith(EVALUATE) for a in ancestors(e)):
                self.forward[(e.thread, e.sequence_nr)] = e

    def device_rows(self) -> list:
        """The device rows that take device time: kernels, copies and
        memsets (no range spans, no optimizer annotation)."""
        return [
            e for e in self.events
            if e.device_type != CPU and not getattr(e, "is_user_annotation", False)
            and e.name not in self.ranges and not e.name.startswith("Optimizer.")
            and e.time_range.elapsed_us() > 0
        ]

    def range_of(self, op) -> str | None:
        return next((a.name for a in ancestors(op) if a.name in self.ranges), None)

    def group_of_op(self, op) -> str:
        for a in ancestors(op):
            if a.name.startswith(EVALUATE):
                thread = getattr(a, "fwd_thread", None) or a.thread
                fwd = self.forward.get((thread, a.sequence_nr))
                base = self.range_of(fwd) if fwd is not None else None
                return backward_group(base) if base else UNATTRIBUTED
            if a.name in self.ranges:
                return a.name
        return UNATTRIBUTED

    def is_layout_op(self, op) -> bool:
        if op.name != "aten::copy_":
            return False
        dtypes = getattr(op, "input_dtypes", None) or self.dtypes.get(op.id, [])
        if len(dtypes) >= 2 and dtypes[0] != dtypes[1]:
            return False
        return any(a.name in LAYOUT_PARENTS for a in ancestors(op.cpu_parent))

    def launcher(self, row):
        call = self.runtime.get(row.id)
        if call is not None and call.cpu_parent is not None:
            return call.cpu_parent
        linked = getattr(row, "linked_correlation_id", None)
        if linked is None:
            linked = self.linked.get((row.id, round(row.time_range.start * 1000)), 0)
        return self.ops.get(linked or -1)

    def group(self, row) -> str:
        """The group of a device row."""
        op = self.launcher(row)
        if any(m in row.name.lower() for m in LAYOUT_KERNELS):
            return LAYOUT
        if op is None:
            return UNATTRIBUTED
        return LAYOUT if self.is_layout_op(op) else self.group_of_op(op)
