"""Where a train step's device time goes, by op group, against each group's floor.

    python -m palette_and_histo_gan_tpu_torch.roofline [--variant histogram]
        [--batch 1024] [--dtype bfloat16] [--steps 3] [--out-dir build]
        [--device cuda|cpu]

The counterpart of `scripts/roofline.py` on the card. It profiles
`--steps` steps of the production chunk (`sweep.py`'s program, after a
2-step warm-up) under torch.profiler with `record_shapes=True` and puts
each kernel's device time in one group:

  * a forward kernel takes the innermost named range of the op that
    launched it (the op around the runtime call with the kernel's
    correlation id, else the op its linked correlation id names; the
    step's ranges are `train/steps.py`'s "batch-gather", "augment",
    "G-fwd", "D-fwd", "hist-fwd", "loss", "optimizer");
  * a backward kernel takes the "-bwd" group of the forward op whose
    autograd node ran it ("G-bwd", "D-bwd", "hist-bwd", "loss-bwd"): the
    profiler's sequence number ties an `autograd::engine::evaluate_function`
    row to the last forward op that recorded it, the counterpart of the JAX
    prefix `transpose(jvp(...))`;
  * layout kernels go to "copy/layout" whatever their range: a same-dtype
    `aten::copy_` under `aten::contiguous`, `aten::clone` or
    `aten::reshape`, and cuDNN's layout transforms (LAYOUT_KERNELS);
  * what is left goes to "unattributed", and its share is printed.

Floors a step, for each group:

  * **tensor cores**: `utils/flops.py`'s counts with the JAX roofline's
    multipliers (`scripts/roofline.py::mxu_group_floors`): G-fwd one
    generator forward, G-bwd two, D-fwd three discriminator forwards, D-bwd
    three (two for indexed, whose argmax blocks the input gradient),
    hist-fwd two histogram evaluations' products, hist-bwd three; at the
    dtype's peak (utils/roofline.py::PEAK; float32 runs with TF32 off);
  * **bytes**: the recorded inputs of the group's ops that launched a
    kernel, each op once, at 3.35 TB/s. Outputs are not recorded, so this
    is a lower bound. Each input counts its elements along its non-zero
    strides (a broadcast view counts its storage); identical inputs of one
    op (same shape, strides and dtype) count once, so that `x * x` does not
    count x twice. Ops that read only part of an input count the part they
    read, their output's size: `aten::index`, `aten::index_select`,
    `aten::gather`, `aten::take`, `aten::embedding` (GATHER_OPS); a slicing
    copy reads a view, whose recorded shape is already the part;
  * **the hand-written kernels**: their own counts, `ops/histogram_kernel.py
    ::work` through `utils/roofline.py::histogram_bound` for each histogram
    launch (hist-fwd, hist-bwd) and `utils/roofline.py::augment_bound` for
    each K1 launch (augment), from the launches counted in the profile.

"copy/layout" and "unattributed" get no floor: a layout copy may overlap
or alias nothing, as the JAX script says of its own. A group for which the
repository has no count of a kind gets null for it, never a guess. The
bound is the largest floor a group has, its ratio the measured time over
it; the composite sets the measured step against the sum of the group
bounds. Prints the card's line, the table, and writes
`--out-dir/roofline_<variant>.json` (under `build/`). `--device cpu`
attributes each op's own CPU time instead (a test of the attribution;
no floor is a CPU's).
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys

import torch

from .config import MODEL_VARIANTS
from .utils import flops, profiling, tracing
from .utils.roofline import PEAK, augment_bound, histogram_bound

RANGES = ("batch-gather", "augment", "G-fwd", "D-fwd", "hist-fwd", "loss", "optimizer")
# the step's other spans (train/steps.py), ranges too while a profiler records
SPAN_RANGES = RANGES + ("G-bwd", "D-bwd", "allreduce")
LAYOUT = "copy/layout"
UNATTRIBUTED = "unattributed"
NO_FLOOR_GROUPS = (LAYOUT, UNATTRIBUTED)
EVALUATE = "autograd::engine::evaluate_function"
# the ops under which a same-dtype copy_ is a layout copy
LAYOUT_PARENTS = ("aten::contiguous", "aten::clone", "aten::reshape")
# cuDNN's layout transforms, by kernel name (lower case)
LAYOUT_KERNELS = ("nchwtonhwc", "nhwctonchw", "transpose_readwrite", "tensortransform")
GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather", "aten::take",
              "aten::embedding")
ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "int": 4,
            "long int": 8, "unsigned char": 1, "signed char": 1, "bool": 1, "short int": 2,
            "short": 2, "long": 8}


def backward_group(group: str) -> str:
    """"G-fwd" -> "G-bwd", "loss" -> "loss-bwd"."""
    return group[:-len("-fwd")] + "-bwd" if group.endswith("-fwd") else group + "-bwd"


def _ancestors(event):
    while event is not None:
        yield event
        event = event.cpu_parent


def _is_runtime(event) -> bool:
    """A call of the CUDA API on the host (cudaLaunchKernel, cuLaunchKernelEx)."""
    name = event.name
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn") and (
        name[2:3].isupper() or name[4:5].isupper())


def _call(obj, *names, default=None):
    """The first of `obj`'s methods `names` that exists, called."""
    for name in names:
        if hasattr(obj, name):
            return getattr(obj, name)()
    return default


class KinetoIndex:
    """What a FunctionEvent of some PyTorch versions does not carry, from
    the profile's raw events: each device row's linked correlation id (the
    id of the op that launched it) and each op's input dtypes and strides."""

    def __init__(self, prof):
        results = prof.profiler.kineto_results
        start = results.trace_start_ns()
        self.linked, self.inputs = {}, {}
        for k in results.events():
            if k.device_type() == torch.autograd.DeviceType.CPU:
                self.inputs[k.correlation_id()] = (
                    _call(k, "dtypes", default=[]),
                    _call(k, "structured_input_strides", "strides", default=[]))
            else:
                self.linked[(k.correlation_id(), k.start_ns() - start)] = k.linked_correlation_id()

    def linked_id(self, row) -> int:
        linked = getattr(row, "linked_correlation_id", None)
        if linked is None:
            linked = self.linked.get((row.id, round(row.time_range.start * 1000)), 0)
        return linked

    def dtypes_and_strides(self, op) -> tuple[list, list]:
        dtypes = getattr(op, "input_dtypes", None)
        strides = getattr(op, "structured_input_strides", None)
        if dtypes is None or strides is None:
            raw = self.inputs.get(op.id, ([], []))
            dtypes = raw[0] if dtypes is None else dtypes
            strides = raw[1] if strides is None else strides
        return list(dtypes or []), list(strides or [])


class Attribution:
    """Groups of the profile's ops and device rows."""

    def __init__(self, prof):
        events = prof.events()
        self.index = KinetoIndex(prof)
        cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        self.ops = {e.id: e for e in cpu if not _is_runtime(e)}
        # a launch's runtime call shares the device row's correlation id
        self.runtime = {e.id: e for e in cpu if _is_runtime(e)}
        # (thread, sequence number) -> the last forward op that recorded it:
        # the one that created the autograd node of that number (the ops
        # before it in the same count create none)
        self.forward = {}
        for e in sorted(cpu, key=lambda e: e.time_range.start):
            if e.sequence_nr >= 0 and not any(a.name.startswith(EVALUATE) for a in _ancestors(e)):
                self.forward[(e.thread, e.sequence_nr)] = e

    @staticmethod
    def range_of(op) -> str | None:
        return next((a.name for a in _ancestors(op) if a.name in RANGES), None)

    def forward_op(self, evaluate):
        thread = getattr(evaluate, "fwd_thread", None) or evaluate.thread
        return self.forward.get((thread, evaluate.sequence_nr))

    def group_of_op(self, op) -> str:
        """The op's range; under an autograd node, the -bwd group of the
        range of the forward op that created the node."""
        for a in _ancestors(op):
            if a.name.startswith(EVALUATE):
                fwd = self.forward_op(a)
                base = self.range_of(fwd) if fwd is not None else None
                return backward_group(base) if base else UNATTRIBUTED
            if a.name in RANGES:
                return a.name
        return UNATTRIBUTED

    def is_layout_op(self, op) -> bool:
        """A same-dtype copy_ under contiguous, clone or reshape."""
        if op.name != "aten::copy_":
            return False
        dtypes, _ = self.index.dtypes_and_strides(op)
        if len(dtypes) >= 2 and dtypes[0] != dtypes[1]:
            return False
        return any(a.name in LAYOUT_PARENTS for a in _ancestors(op.cpu_parent))

    def group(self, op) -> str:
        return LAYOUT if self.is_layout_op(op) else self.group_of_op(op)

    def launcher(self, kernel):
        """The op that launched a device row: the op (or range) around the
        runtime call that launched it, or else the op its linked
        correlation id names."""
        call = self.runtime.get(kernel.id)
        if call is not None and call.cpu_parent is not None:
            return call.cpu_parent
        return self.ops.get(self.index.linked_id(kernel) or -1)

    @staticmethod
    def describe(kernel, op) -> str:
        """A device row, the op that launched it and the autograd node or
        range around that op, for the unattributed rows' report."""
        if op is None:
            return f"{kernel.name[:60]} <- (no op)"
        around = next((a.name for a in _ancestors(op)
                       if a.name.startswith(EVALUATE) or a.name in RANGES), "(no range)")
        return f"{kernel.name[:60]} <- {op.name} <- {around.replace(EVALUATE, 'node')}"

    def kernel_group(self, kernel) -> tuple[str, object]:
        """(group, launching op or None) of a device row."""
        op = self.launcher(kernel)
        if any(m in kernel.name.lower() for m in LAYOUT_KERNELS):
            return LAYOUT, op
        return (UNATTRIBUTED if op is None else self.group(op)), op


def device_rows(prof) -> list:
    """The profile's device rows that take device time: kernels, copies and
    memsets, as utils/profiling.py::device_events counts them (no range
    spans, no optimizer annotation)."""
    return [
        e for e in prof.events()
        if e.device_type != torch.autograd.DeviceType.CPU
        and not getattr(e, "is_user_annotation", False) and e.name not in RANGES
        and not e.name.startswith("Optimizer.") and e.time_range.elapsed_us() > 0
    ]


def _numel(shape, strides) -> int:
    """Elements along the non-zero strides (a broadcast view's storage)."""
    if strides and len(strides) == len(shape):
        return math.prod(d for d, s in zip(shape, strides) if s != 0)
    return math.prod(shape)


def _is_shape(x) -> bool:
    return isinstance(x, (list, tuple)) and all(isinstance(d, int) for d in x)


def op_bytes(op, dtypes: list, strides: list) -> int:
    """A lower bound of the bytes an op reads: its recorded tensor inputs
    (their `dtypes` and `strides`), each along its non-zero strides,
    identical inputs once; a gather its output's size (GATHER_OPS)."""
    shapes = list(op.input_shapes or [])
    size = [ITEMSIZE.get(d, 0) for d in dtypes] + [0] * len(shapes)
    if op.name in GATHER_OPS and shapes and _is_shape(shapes[0]) and size[0]:
        return size[0] * _gathered(op.name, shapes, getattr(op, "concrete_inputs", None))
    seen, total = set(), 0
    for i, shape in enumerate(shapes):
        if not _is_shape(shape) or not shape and not size[i]:
            continue
        stride = strides[i] if i < len(strides) and _is_shape(strides[i]) else None
        key = (tuple(shape), tuple(stride or ()), dtypes[i] if i < len(dtypes) else None)
        if key in seen:
            continue
        seen.add(key)
        total += size[i] * _numel(shape, stride)
    return total


def _gathered(name: str, shapes: list, concrete) -> int:
    """Elements of a gather's output, from its inputs' shapes."""
    source = shapes[0]
    if name == "aten::index":
        index = [s for s in (shapes[1] if len(shapes) > 1 else []) if _is_shape(s) and s]
        if not index:
            return math.prod(source)
        return math.prod(index[0]) * math.prod(source[len(index):])
    if name in ("aten::index_select",):
        dim = int(concrete[1]) if concrete and len(concrete) > 1 and concrete[1] != "" else 0
        return math.prod(source) // max(source[dim], 1) * math.prod(shapes[2])
    if name == "aten::embedding":  # (weight, indices): rows of the weight
        return math.prod(shapes[1]) * source[-1]
    return math.prod(shapes[-1] if name == "aten::take" else shapes[2])


def attribute_device(prof, steps: int) -> tuple[dict, dict, float, dict]:
    """(measured ms a step by group, bytes a step by group, the device ms a
    step as utils/profiling.py::device_seconds counts it, the unattributed
    rows' ms a step by kernel, launching op and what is around it)."""
    attribution = Attribution(prof)
    measured = collections.Counter()
    moved = collections.Counter()
    unattributed = collections.Counter()
    launched = {}
    for row in device_rows(prof):
        group, op = attribution.kernel_group(row)
        ms = row.time_range.elapsed_us() / 1e3 / steps
        measured[group] += ms
        if group == UNATTRIBUTED:
            unattributed[attribution.describe(row, op)] += ms
        if op is not None:
            launched[op.id] = op
    for op in launched.values():
        group = attribution.group(op)
        if group not in NO_FLOOR_GROUPS:
            moved[group] += op_bytes(op, *attribution.index.dtypes_and_strides(op)) / steps
    total = 1e3 * profiling.device_seconds(prof) / steps
    return dict(measured), dict(moved), total, dict(unattributed.most_common(8))


def attribute_cpu(prof) -> dict:
    """Each CPU row with own time (ops, autograd nodes, the optimizer's
    annotation), not a range -> its group: the attribution a CPU test can
    see."""
    attribution = Attribution(prof)
    return {
        e: (LAYOUT if attribution.is_layout_op(e) else attribution.group_of_op(e))
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU and e.name not in SPAN_RANGES
        and e.self_cpu_time_total > 0
    }


def tensor_core_flops(config, batch: int) -> dict:
    """The matrix FLOPs a step of each group, with the JAX roofline's
    multipliers (scripts/roofline.py::mxu_group_floors, before its peak)."""
    g_fwd = flops._generator_fwd_flops(config) * batch
    d_fwd = flops._discriminator_fwd_flops(config) * batch
    groups = {"G-fwd": g_fwd, "G-bwd": 2.0 * g_fwd, "D-fwd": 3.0 * d_fwd,
              "D-bwd": (2.0 if config.is_indexed else 3.0) * d_fwd}
    if config.model == "histogram":
        hist = flops._histogram_dot_flops(config) * batch
        groups["hist-fwd"] = 2.0 * hist
        groups["hist-bwd"] = 3.0 * hist
    return groups


def kernel_floors(config, batch: int, launches: dict, bf16_launches: dict, steps: int) -> dict:
    """ms a step of the hand-written kernels' own bounds, by group, from
    the launches counted in the profile: the histogram kernels through
    work() and histogram_bound, K1 through augment_bound."""
    from .config import compute_dtype
    from .ops import histogram_kernel as hk

    out = collections.Counter()
    for name, n in launches.items():
        if name in hk.FORWARD_KERNELS + hk.BACKWARD_KERNELS and n:
            direction = "fwd" if name in hk.FORWARD_KERNELS else "bwd"
            n_bf16 = bf16_launches.get(name, 0)
            for count, chain in ((n_bf16, torch.bfloat16), (n - n_bf16, torch.float32)):
                if count:
                    w = hk.work(direction, batch, 64 * 64, config.histogram_size, chain)
                    out[f"hist-{direction}"] += count * histogram_bound(w)[0] / steps
    if launches.get("K1"):
        itemsize = compute_dtype(config).itemsize
        out["augment"] += launches["K1"] * augment_bound(batch, itemsize)[0] / steps
    return dict(out)


def table(config, measured: dict, moved: dict, total_ms: float, kernel_ms: dict) -> dict:
    """The rows (group, measured ms, the floors, bound, ratio) and the
    composite, a step."""
    tensor = tensor_core_flops(config, config.batch_size)
    peak = PEAK["bfloat16" if config.compute_dtype == "bfloat16" else "float32"]
    rows = []
    for group in sorted(set(measured) | set(tensor) | set(kernel_ms), key=lambda g: -measured.get(g, 0)):
        floors = {"bytes_floor_ms": None, "tensor_core_floor_ms": None, "kernel_floor_ms": None}
        if group not in NO_FLOOR_GROUPS:
            if group in moved:
                floors["bytes_floor_ms"] = 1e3 * moved[group] / PEAK["bytes"]
            if group in tensor:
                floors["tensor_core_floor_ms"] = 1e3 * tensor[group] / peak
            if group in kernel_ms:
                floors["kernel_floor_ms"] = kernel_ms[group]
        known = {k: v for k, v in floors.items() if v is not None}
        bound = max(known.values()) if known else None
        ms = measured.get(group, 0.0)
        rows.append({
            "group": group, "measured_ms": ms, **floors, "bound_ms": bound,
            "bound_by": max(known, key=known.get)[:-len("_floor_ms")] if known else None,
            "ratio": ms / bound if bound else None,
        })
    floor_sum = sum(r["bound_ms"] for r in rows if r["bound_ms"])
    groups_ms = sum(measured.values())
    return {
        "rows": rows, "step_device_ms": total_ms, "groups_ms": groups_ms,
        "unattributed_share": measured.get(UNATTRIBUTED, 0.0) / total_ms if total_ms else None,
        "floor_sum_ms": floor_sum, "ratio": total_ms / floor_sum if floor_sum else None,
    }


def run(variant: str, batch: int, dtype: str, steps: int, device, **config_kw) -> dict:
    """Profile `steps` steps of the production chunk and tabulate them."""
    from .ops import histogram_kernel
    from .sweep import launches_since, prepare, read_launches

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("roofline.run times the card; --device cpu goes through attribute_cpu")
    setup = prepare(variant, batch, dtype, device, **config_kw)
    setup.timed(2)  # warm-up: cuDNN plans, the allocator, the kernels' libraries
    before, bf16_before = read_launches(), dict(histogram_kernel.bf16_launches)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        setup.run(steps)
        torch.cuda.synchronize(device)
    tracing.clear()  # the spans the profile recorded: its ranges hold what is read
    launches = launches_since(before)
    bf16 = {k: n - bf16_before[k] for k, n in histogram_kernel.bf16_launches.items()}
    measured, moved, total, unattributed = attribute_device(prof, steps)
    kernel_ms = kernel_floors(setup.config, batch, launches, bf16, steps)
    out = table(setup.config, measured, moved, total, kernel_ms)
    out.update(variant=variant, batch=batch, dtype=dtype, steps=steps,
               histogram_impl=setup.config.histogram_impl,
               launches_per_step={k: v / steps for k, v in launches.items()},
               unattributed_rows_ms=unattributed)
    return out


def format_table(out: dict) -> str:
    def ms(v):
        return f"{v:9.3f}" if v is not None else f"{'-':>9s}"

    lines = [f"{'group':14s} {'measured':>9s} {'bytes':>9s} {'tensor':>9s} {'kernel':>9s} "
             f"{'bound':>9s} {'ratio':>7s}"]
    for r in out["rows"]:
        ratio = f"{r['ratio']:6.2f}x" if r["ratio"] is not None else f"{'-':>7s}"
        lines.append(f"{r['group']:14s} {ms(r['measured_ms'])} {ms(r['bytes_floor_ms'])} "
                     f"{ms(r['tensor_core_floor_ms'])} {ms(r['kernel_floor_ms'])} "
                     f"{ms(r['bound_ms'])} {ratio}")
    lines.append(
        f"step {out['step_device_ms']:.3f} ms of device time (groups {out['groups_ms']:.3f}, "
        f"unattributed {100 * out['unattributed_share']:.2f}%), sum of group floors "
        f"{out['floor_sum_ms']:.3f} ms: the step is {out['ratio']:.2f}x its composite floor")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-roofline", description=__doc__.split("\n")[0])
    p.add_argument("--variant", choices=MODEL_VARIANTS, default="histogram")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out-dir", default="build")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("roofline: PyTorch sees no CUDA device (--device cpu attributes "
                         "CPU time)")
    if device.type == "cpu":
        return _main_cpu(args)
    card = profiling.card_line()
    print(card, flush=True)
    out = run(args.variant, args.batch, args.dtype, args.steps, device)
    print(format_table(out), flush=True)
    path = profiling.write_build_json(os.path.join(args.out_dir, f"roofline_{args.variant}.json"),
                                      {"card": card, **out})
    print(f"wrote {path}", flush=True)
    return 0


def _main_cpu(args) -> int:
    """The attribution on the CPU: each op's own CPU time by group."""
    from .sweep import prepare

    setup = prepare(args.variant, args.batch, args.dtype, "cpu")
    setup.run(1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        setup.run(args.steps)
    tracing.clear()
    by_group = collections.Counter()
    for event, group in attribute_cpu(prof).items():
        by_group[group] += event.self_cpu_time_total / 1e3 / args.steps
    print("cpu: no card; each op's own CPU ms a step by group (no floor is a CPU's)")
    print(json.dumps(dict(by_group.most_common())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
