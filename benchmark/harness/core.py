"""One run of one cell: set-up, the first steps, the window, the reference,
the comparison and the result line.

Set-up (counted in setup_s from the process's start to the first timed
step): the program's import and its kernels (built into build/ of the
checkout at the first run, loaded after), the data and the weights drawn on
the device from the seed, the program's state, the first `check_steps`
steps through the window's own call (what `correct` compares), the entry's
warm-up. Then the window: the cell's entry for --seconds, its end-to-end
metrics on the host clock; with --trace 1 the profiler over its first
`trace_chunks` chunks and the per-layer metrics read from that. Then, with
the program's state freed, the reference's steps from the same inputs, and
the comparison against limits/<cell>.json.

A cell of several chips runs one process a card: this process is rank 0
and starts the others (the same command with --rank), joined through a
file rendezvous in a fresh directory under TMPDIR; rank 0 alone prints.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import torch

from ..counts import traffic as traffic_gen
from ..counts import weights as weights_gen
from ..reference import compare
from . import card, guard, program, spec
from .trace import Tracer, View

RUN_PY = os.path.join(spec.BENCH_DIR, "run.py")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the ranks after 0 of a cell of several chips
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    # the benchmark's own CPU tests and calibrate.py; a measured run passes none
    p.add_argument("--test-device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--test-overrides", default=None, help=argparse.SUPPRESS)
    p.add_argument("--plant-fault", default=None, help=argparse.SUPPRESS)
    return p


def apply_overrides(cell, overrides: dict | None):
    """A test's narrow widths and small traffic: {"settings": {...},
    "traffic": {...}, "limits": {...}, "chips": n}."""
    if not overrides:
        return cell
    if "settings" in overrides:
        cell.config["settings"].update(overrides["settings"])
    cell.traffic.update(overrides.get("traffic", {}))
    for name, limit in overrides.get("limits", {}).items():
        cell.limits[name] = {"limit": limit}
    cell.chips = overrides.get("chips", cell.chips)
    return cell


def _die_with_parent() -> None:
    import ctypes

    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


class Ranks:
    """Ranks 1..N-1 as child processes of rank 0, stopped on failure."""

    def __init__(self, argv: list[str], world: int, rendezvous: str, script: str = RUN_PY):
        self.procs = [
            subprocess.Popen([sys.executable, script, *argv, "--rank", str(r),
                              "--rendezvous", rendezvous],
                             stdout=sys.stderr, preexec_fn=_die_with_parent)
            for r in range(1, world)
        ]
        self.done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.done.wait(1.0):
            failed = [p for p in self.procs if p.poll() not in (None, 0)]
            if failed:
                print(f"a rank ended with {failed[0].returncode}; stopping the run",
                      file=sys.stderr, flush=True)
                self.kill()
                os._exit(4)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            self.done.set()
            self.kill()
        bad = [p.returncode for p in self.procs if p.returncode != 0]
        if bad:
            raise SystemExit(f"ranks ended with {bad}")


def _agree(group):
    """Rank 0's decision on every rank (one broadcast), or the decision."""
    if group is None:
        return lambda flag: flag

    def agree(flag: bool) -> bool:
        t = torch.tensor([1 if flag else 0], device=group.device)
        torch.distributed.broadcast(t, 0)
        return bool(t.item())

    return agree


def _reduce(group, values: list[float], op) -> list[float]:
    if group is None:
        return values
    t = torch.tensor(values, dtype=torch.float64, device=group.device)
    torch.distributed.all_reduce(t, op=op)
    return t.tolist()


def find_device(args, cell):
    """The rank's device, or None (with the reason on standard error) where
    the cell's cards are not there."""
    if args.test_device:
        return torch.device(args.test_device)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the port on a card", file=sys.stderr)
        return None
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, PyTorch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return None
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    return device


def with_ranks(args, cell, device, body, script: str = RUN_PY):
    """body(group) on this rank; for a cell of several cards rank 0 first
    starts the others (`script` with this process's arguments) on a
    rendezvous file under TMPDIR, waits for them after body, and stops any
    that is left."""
    if cell.chips == 1:
        return body(None)
    ranks = rendezvous_dir = None
    if args.rank == 0:
        rendezvous_dir = tempfile.mkdtemp(prefix="phg-bench-ranks-")
        args.rendezvous = os.path.join(rendezvous_dir, "store")
        ranks = Ranks(sys.argv[1:], cell.chips, args.rendezvous, script)
    try:
        from palette_and_histo_gan_tpu_torch.parallel.mesh import make_group

        group = make_group(device, init_method="file://" + args.rendezvous,
                           world_size=cell.chips, rank=args.rank)
        code = body(group)
        if ranks is not None:
            ranks.wait()
        return code
    finally:
        if ranks is not None:
            ranks.kill()
        if rendezvous_dir:
            shutil.rmtree(rendezvous_dir, ignore_errors=True)


class Phases:
    """Host seconds of each part of set-up, in the order they ran."""

    def __init__(self, since: float | None = None):
        self.seconds: dict[str, float] = {}
        self.last = time.perf_counter() if since is None else since

    def mark(self, name: str, sync=None) -> None:
        if sync is not None and sync.type == "cuda":
            torch.cuda.synchronize(sync)
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f}" for k, v in self.seconds.items())


def first_steps(cell, seed: int, device, group, phases: Phases | None = None):
    """The cell's set-up from `seed`: the model's data and weights drawn on
    the device, the entry's program built on them, its first `check_steps`
    steps taken and read. Returns (ctx, entry, readings)."""
    phases = phases or Phases()
    seeds = traffic_gen.sub_seeds(seed)
    model = cell.model
    ctx = types.SimpleNamespace(cell=cell, device=device, group=group, seeds=seeds,
                                agree=_agree(group))
    ctx.data = model.make_splits(cell.config, cell.traffic, seeds["data"], device)
    phases.mark("data", device)
    ctx.weights = weights_gen.draw(model.parameter_shapes(cell.config), seeds["weights"], device)
    phases.mark("weights", device)
    entry = spec.entry(cell.traffic["entry"])
    entry.setup(ctx)
    phases.mark("program", device)
    readings = program.first_readings(cell, ctx.run_chunk, ctx.state, ctx.weights,
                                      cell.traffic["check_steps"])
    phases.mark("first_steps", device)
    ctx.weights = None
    return ctx, entry, readings


def reference_readings(cell, ctx, precision: str = "float32") -> dict:
    """The model's reference steps from the run's seeds and data, the
    weights drawn again from the seed."""
    model = cell.model
    w = weights_gen.draw(model.parameter_shapes(cell.config), ctx.seeds["weights"], ctx.device)
    return model.reference_train(cell.config, cell.traffic, w, ctx.data["train"], ctx.seeds,
                                 cell.traffic["check_steps"], precision)


def run(args, t_start: float, out) -> int:
    phases = Phases(t_start)
    phases.mark("imports")
    overrides = json.loads(args.test_overrides) if args.test_overrides else None
    cell = apply_overrides(spec.cell(args.workload), overrides)
    device = find_device(args, cell)
    if device is None:
        return 2
    if args.plant_fault:
        from .. import faults

        faults.plant(args.plant_fault, cell.model)
    printed = with_ranks(args, cell, device,
                         lambda group: _run_rank(args, cell, device, group, t_start, phases))
    if printed is not None:  # rank 0, every other rank ended
        stdout_lines, stderr_lines = printed
        print("\n".join(stdout_lines), file=out, flush=True)
        sys.stderr.flush()
        print("\n".join(stderr_lines), file=sys.stderr, flush=True)
    return 0


def _run_rank(args, cell, device, group, t_start, phases):
    """This rank's run; on rank 0 the lines it prints, standard output's
    (the last one the result) and standard error's (the checks last)."""
    t = cell.traffic
    world, rank = cell.chips, args.rank
    phases.mark("device" if group is None else "device_and_ranks", device)
    ctx, entry, readings = first_steps(cell, args.seed, device, group, phases)
    entry.warm(ctx)
    guard.check("after set-up")
    on_card = device.type == "cuda"
    sampler = card.Sampler(device.index or 0)
    if on_card and rank == 0:
        sampler.start()
    launches0 = card.read_launches()
    if group is not None:
        group.barrier()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    phases.mark("warm")
    tracer = Tracer(bool(args.trace), t["trace_chunks"], device, lambda: ctx.state.step)
    win = entry.window(ctx, args.seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    sampler.stop()
    launches = {k: (n - launches0.get(k, 0)) / win["steps"] for k, n in card.read_launches().items()
                if n > launches0.get(k, 0)}
    guard.check("after the window")
    view = None
    if args.trace:
        view = View(tracer.prof, cell, world, tracer.steps)
    busy = view.busy_s if view is not None else 0.0
    peak, = _reduce(group, [float(peak)], torch.distributed.ReduceOp.MAX if group else None)
    busy_sum, = _reduce(group, [busy], torch.distributed.ReduceOp.SUM if group else None)
    entry.free(ctx)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if group is not None:
        from palette_and_histo_gan_tpu_torch.parallel import distributed

        distributed.shutdown()
        if rank:
            guard.check("at the rank's end")
            return None

    bad_steps = sum(1 for i in range(0, len(win["losses"]), 2)
                    if not all(map(math.isfinite, win["losses"][i:i + 2])))
    values = compare.numbers(readings, reference_readings(cell, ctx), bad_steps)
    ok, checks = compare.judge(values, cell.limits)

    images = win["steps"] * t["batch_size"]
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values_e2e = {"setup_s": setup_s, "train_img_per_s": images / win["seconds"],
                      "peak_mem_gib": peak / 2**30}
        metrics = {m["name"]: {"value": values_e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": card.device_name(device), "count": world, "memory_peak_bytes": int(peak)}
    if view is not None:
        dev.update(busy_s=busy_sum / world, window_s=view.window_s)
    line = {"correct": ok, "attempted": win["steps"], "failed": bad_steps, "metrics": metrics,
            "device": dev}
    if view is not None:
        line["breakdown"] = view.breakdown()
    line["checks"] = checks
    # the reference, the comparison and the metric readers (files a later
    # change may add) have run: nothing of them may have loaded JAX
    guard.check("before the result")

    card_text = card.card_line(device.index or 0) if on_card else f"{device}: no card"
    stdout_lines = [
        f"card: {card_text}; beside the window {sampler.summary()}",
        f"launches a step: {json.dumps(launches, sort_keys=True)}; window {win['steps']} steps "
        f"in {win['seconds']:.3f} s, setup {setup_s:.3f} s",
        f"setup phases (s): {phases.line()}",
        json.dumps(line),
    ]
    stderr_lines = [f"check {name}: {c['value']!r} limit {c['limit']!r}"
                    for name, c in checks.items()] + [f"correct: {ok}"]
    return stdout_lines, stderr_lines
