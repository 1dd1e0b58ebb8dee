"""Throughput sweep of the four variants over a batch ladder, on the card.

    python -m palette_and_histo_gan_tpu_torch.sweep [--batches 4 16 64 256 1024]
        [--steps 20] [--dtype bfloat16] [--variants ...] [--override KEY=VALUE]
        [--out build/sweep_results.json] [--device cuda|cpu]
    torchrun --nproc-per-node=N -m palette_and_histo_gan_tpu_torch.sweep \
        --data-parallel on ...

The counterpart of `scripts/sweep.py` (`measure_variant`, `main`). Each
row builds a full-width configuration of the variant (29.3M generator
parameters) on seeded synthetic data made as the script makes it: uint8
RGBA (n, 64, 64, 4) pairs, which the chunk packs to a word a pixel so that
the packed gather and the augmentation kernel K1 engage, or int32 index
maps (n, 64, 64, 1) in 0-255 for the indexed variant, n = max(1024,
batch). It times the production program, `train/steps.py::
make_train_chunk`, after a warm-up of as many steps as it times:

  * the device clock, `utils/profiling.py::device_step_seconds`: the
    summed device time of a chunk under torch.profiler, a step
    (`step_seconds`, `clock: "device"`);
  * the host clock around a synchronized chunk (`host_step_seconds`),
    with the peak device memory and the kernels' launches a step counted
    around that chunk.

MFU is the step's FLOPs (`utils/flops.py`) over the card's peak for the
dtype (989 TFLOP/s bfloat16; 67 float32, which runs with TF32 off under
`config.py::float32_exact`) and over the world size (`utils/roofline.py::
mfu`), as the script divides by its chips. `--device cpu` is a request,
not a fallback: `clock: "host"`, `step_seconds` the host clock's, and the
device fields (`device_step_seconds`, `peak_device_memory_bytes`, `mfu`)
null. On a card nothing falls back to the host clock: no device time
raises.

`histogram_impl` is what the CLI picks on a card, "pallas2" (kernels K3b,
K4b); `--override histogram_impl=xla` (the plain torch path), `=pallas`
(K3a, K4a) or `histogram_bwd=pallas` (K4c) keep the script's A/B. A row
that runs out of device memory (`torch.cuda.OutOfMemoryError`) becomes an
error row; any other exception raises.

Under torchrun (`--data-parallel on`, or "auto" with more than one rank)
the batch is the global batch, split over the ranks through
`train/trainer.py::data_group` (a batch that does not split raises);
every rank holds the whole data and times its own card, and rank 0 alone
prints and writes. Prints the card's line first, then a JSON line a row;
writes `--out`, which must lie under `build/`.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from .config import MODEL_VARIANTS, Config, config_for_variant, float32_exact
from .ops import augment_kernel, histogram_kernel, moments, palette_kernel
from .utils import flops, profiling
from .utils.roofline import mfu

BATCHES = (4, 16, 64, 256, 1024)
VARIANTS = ("baseline-no-aug", "baseline", "indexed", "histogram")
MIN_DATA = 1024
DATA_SEED = 0
STATE_SEED = 0
# the kernels' launch counters, by the TPU kernel each stands in for
COUNTERS = ((augment_kernel.launches, {"packed": "K1", "rgba": "K2"}),
            (histogram_kernel.launches, {}), (palette_kernel.launches, {}),
            (moments.launches, {}))


def read_launches() -> dict:
    """Every kernel's launches in this process so far, by TPU kernel."""
    return {names.get(key, key): n for counts, names in COUNTERS for key, n in counts.items()}


def launches_since(before: dict) -> dict:
    """The launches since `before` (a read_launches()), the kernels that ran."""
    return {k: n - before[k] for k, n in read_launches().items() if n > before[k]}


def synthetic_data(config: Config, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (sources, targets) as scripts/sweep.py makes them: uint8 RGBA
    (n, 64, 64, 4), or int32 index maps (n, 64, 64, 1) in 0-255."""
    rng = np.random.default_rng(DATA_SEED)
    if config.is_indexed:
        arrays = [rng.integers(0, 256, (n, 64, 64, 1)).astype(np.int32) for _ in range(2)]
    else:
        arrays = [rng.integers(0, 256, (n, 64, 64, 4)).astype(np.uint8) for _ in range(2)]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def default_histogram_impl(device: torch.device) -> str:
    """cli.py's default: "pallas2" (the kernels) on a card, "xla" on the CPU."""
    return "pallas2" if device.type == "cuda" else "xla"


@dataclasses.dataclass
class Setup:
    """One row's program: its config, state, resident data and chunk."""
    config: Config
    device: torch.device
    state: object
    dataset: tuple
    chunk: Callable
    world: int

    def run(self, n: int) -> dict:
        """n steps of the chunk; the stacked metrics, still on the device."""
        exact = self.config.compute_dtype == "float32"
        with float32_exact() if exact else contextlib.nullcontext():
            return self.chunk(self.state, self.dataset, n)

    def timed(self, n: int) -> float:
        """Host seconds of n steps, ended by fetching the last step's loss."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        metrics = self.run(n)
        float(metrics["generator/total_loss"][-1])
        return time.perf_counter() - t0


def prepare(variant: str, batch: int, dtype: str, device, overrides: dict | None = None,
            data_parallel: str = "off", **config_kw) -> Setup:
    """A row's program: the full-width config (`config_kw` may narrow it),
    the state from STATE_SEED, the resident data and the production chunk,
    over the data-parallel group `data_parallel` asks for."""
    from .parallel.dp import make_dp_train_chunk
    from .parallel.distributed import rank_device
    from .parallel.mesh import replicate_state
    from .train.state import create_train_state
    from .train.steps import make_train_chunk
    from .train.trainer import data_group

    device = rank_device(device)
    settings = dict(histogram_impl=default_histogram_impl(device), data_parallel=data_parallel)
    settings.update(config_kw)
    settings.update(overrides or {})
    config = config_for_variant(variant, compute_dtype=dtype, batch_size=batch, **settings)
    group = data_group(config, device)
    n = max(MIN_DATA, batch)
    state = create_train_state(config, device, STATE_SEED)
    if group is None:
        chunk = make_train_chunk(config, n, config.seed)
    else:
        replicate_state(group, state)
        chunk = make_dp_train_chunk(config, group, n, config.seed)
    return Setup(config, device, state, synthetic_data(config, n, device), chunk,
                 1 if group is None else group.world_size)


def throughput(batch: int, step_seconds: float, world: int, flops_per_image: float,
               dtype: str, on_card: bool) -> dict:
    """The rates of a step of the global `batch` over `world` cards: img/s,
    img/s a card, and MFU (over the world's peak; null off the card)."""
    rate = batch / step_seconds
    return {"images_per_sec": rate, "images_per_sec_per_chip": rate / world,
            "mfu": mfu(flops_per_image, rate, dtype, world) if on_card else None}


def record(setup: Setup, steps: int) -> dict:
    """Warm up with `steps` steps, then time `steps` on the host clock
    (launches and peak memory counted around them) and, on a card,
    `steps` more on the device clock."""
    config, device = setup.config, setup.device
    on_card = device.type == "cuda"
    wall = {"warm_up": setup.timed(steps)}  # the chunk length that is timed
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = read_launches()
    wall["host_clock"] = setup.timed(steps)
    host = wall["host_clock"] / steps
    launches = launches_since(before)
    device_step = None
    if on_card:
        peak = torch.cuda.max_memory_allocated(device)
        t0 = time.perf_counter()
        device_step = profiling.device_step_seconds(setup.run, steps)
        wall["device_clock"] = time.perf_counter() - t0
    step = device_step if on_card else host
    per_image = flops.train_step_flops_per_image(config)
    return {
        "variant": config.model, "batch": config.batch_size, "dtype": config.compute_dtype,
        "n_devices": setup.world, "step_seconds": step,
        **throughput(config.batch_size, step, setup.world, per_image, config.compute_dtype,
                     on_card),
        "flops_per_image": round(per_image),
        "clock": "device" if on_card else "host",
        "device_step_seconds": device_step, "host_step_seconds": host,
        "peak_device_memory_bytes": peak if on_card else None,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "histogram_impl": config.histogram_impl, "histogram_bwd": config.histogram_bwd,
        "device": str(device), "wall_seconds": wall,
    }


def measure_variant(variant: str, batch: int, steps: int, dtype: str, device,
                    overrides: dict | None = None, data_parallel: str = "off",
                    **config_kw) -> dict:
    """One row; a row that runs out of device memory is an error row."""
    try:
        t0 = time.perf_counter()
        setup = prepare(variant, batch, dtype, device, overrides, data_parallel, **config_kw)
        prepared = time.perf_counter() - t0
        out = record(setup, steps)
        out["wall_seconds"]["prepare"] = prepared
    except torch.cuda.OutOfMemoryError as e:
        out = {"variant": variant, "batch": batch, "dtype": dtype, "error": str(e)[:200]}
    finally:
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if overrides:
        out["overrides"] = {k: str(v) for k, v in overrides.items()}
    return out


def parse_overrides(items) -> dict:
    """KEY=VALUE pairs, each value literal-eval'd with a string fallback."""
    out = {}
    for item in items:
        key, _, value = item.partition("=")
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-sweep", description=__doc__.split("\n")[0])
    p.add_argument("--batches", type=int, nargs="*", default=list(BATCHES))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--variants", nargs="*", choices=MODEL_VARIANTS, default=list(VARIANTS))
    p.add_argument("--override", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--data-parallel", choices=["auto", "on", "off"], default="auto",
                   help="data parallelism over torchrun's ranks; the batch is the global batch")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default="build/sweep_results.json")
    return p


def main(argv=None) -> int:
    from .parallel import distributed

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sweep: PyTorch sees no CUDA device (--device cpu runs on the CPU)")
    overrides = parse_overrides(args.override)
    rank0 = os.environ.get("RANK", "0") == "0"
    say = print if rank0 else (lambda *a, **k: None)
    card = profiling.card_line() if device.type == "cuda" else f"{device}: no card"
    say(card, flush=True)
    results = []
    for variant in args.variants:
        for batch in args.batches:
            row = measure_variant(variant, batch, args.steps, args.dtype, device, overrides,
                                  args.data_parallel)
            say(json.dumps(row), flush=True)
            results.append(row)
    if rank0:
        path = profiling.write_build_json(args.out, {
            "card": card,
            "device": torch.cuda.get_device_name(0) if device.type == "cuda" else str(device),
            "n_devices": max([r.get("n_devices", 1) for r in results] or [1]),
            "results": results,
        })
        say(f"wrote {path}", flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
