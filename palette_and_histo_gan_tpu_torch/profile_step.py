"""Where a train step's device time goes, on the card.

    python -m palette_and_histo_gan_tpu_torch.profile_step --model indexed \
        --batch-size 1024 --compute-dtype bfloat16

Builds a full-width Trainer on seeded synthetic sprites (few-colour ones for
the indexed variant), trains `--warmup` steps, then `--steps` steps under
`torch.profiler` and, apart from the profiler, the same number again timed
on the host clock around a synchronized chunk. Prints the card's name and
power limit, then one JSON line: ms/step, the device's busy share over the
profiled window (the kernels' summed device time over the window's wall
time; the kernels of one stream do not overlap) and the kernels with the
most device time a step. Needs a CUDA device; it does not fall back to the
CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .config import MODEL_VARIANTS, config_for_variant
from .utils import profiling, tracing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phg-profile-step", description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=MODEL_VARIANTS, default="indexed")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--histogram-impl", choices=["xla", "pallas", "pallas2"], default="xla")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--seed", type=int, default=47)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: PyTorch sees no CUDA device", file=sys.stderr)
        return 1

    from .data import loader
    from .train.trainer import Trainer

    config = config_for_variant(
        args.model, batch_size=args.batch_size, compute_dtype=args.compute_dtype,
        histogram_impl=args.histogram_impl, temp_folder="build/profile_step",
    )
    device = torch.device("cuda", 0)
    if config.is_indexed:
        datasets = loader.indexed_datasets_from_arrays(
            *loader.synthetic_indexed_arrays(config, args.seed), device,
            config.palette_ordering, config.seed,
        )
    else:
        datasets = loader.datasets_from_arrays(*loader.synthetic_arrays(config, args.seed), device)
    trainer = Trainer(config, device, datasets)
    trainer.fit(steps=args.warmup, update_steps=args.warmup)

    dataset = (trainer.train_ds.sources, trainer.train_ds.targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_chunk(trainer.state, dataset, args.steps)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.train_chunk(trainer.state, dataset, args.steps)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    tracing.clear()  # the spans the profile recorded: its rows hold what is read
    kernels = [
        (e.key, profiling.device_us(e) / args.steps / 1e3, e.count // args.steps)
        for e in profiling.device_events(prof)
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(ms for _, ms, _ in kernels)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({
        "model": config.model, "batch_size": config.batch_size,
        "compute_dtype": config.compute_dtype, "histogram_impl": config.histogram_impl,
        "ms_per_step": host_ms,
        "device_ms_per_step": busy_ms,
        "busy_share": busy_ms * args.steps * 1e3 / window_us,
        "top_kernels": [
            {"name": name[:120], "ms_per_step": ms, "calls_per_step": calls}
            for name, ms, calls in kernels[:args.top]
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
