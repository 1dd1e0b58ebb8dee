"""Benchmark: the histogram variant's train-step throughput on one card.

    PHG_BENCH_BATCH=1024 PHG_BENCH_STEPS=60 PHG_BENCH_DTYPE=bfloat16 \
        python -m palette_and_histo_gan_tpu_torch.bench [--out build/bench.json] \
        [--device cuda|cpu]

The counterpart of the repository's `bench.py`. It times the production
histogram chunk (G forward, both D passes, the histogram loss, both
backward passes, both Adam updates; "pallas2", the CLI's card default,
kernels K3b and K4b) at full width on seeded device-resident data through
`sweep.py::measure_variant`: a warm-up of as many steps as are timed,
then the device clock (`utils/profiling.py::device_step_seconds`).

Prints the card's line, then ONE JSON line with bench.py's keys: metric,
value (img/s), unit, vs_baseline, flops_per_image, mfu (over the card's
peak for the dtype, `utils/roofline.py::PEAK`) and clock ("device").
`vs_baseline` is null: bench.py's north star, 20,000 img/s on a TPU v5e,
is no target for the card. There is no fallback to the host clock on a
card: no device time raises. `--device cpu` is a request: the host clock
(`clock: "host"`) and `mfu` null. The record is also written to `--out`,
under `build/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import sweep
from .utils import profiling


def run(batch: int, steps: int, dtype: str, device) -> dict:
    """bench.py's record of `steps` histogram steps at `batch` in `dtype`
    on `device`."""
    row = sweep.measure_variant("histogram", batch, steps, dtype, device)
    if "error" in row:
        raise RuntimeError(f"bench: batch {batch} {dtype}: {row['error']}")
    return {
        "metric": f"images/sec/chip (64x64 histogram-pix2pix train step, batch {batch}, {dtype})",
        "value": batch / row["step_seconds"],
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "flops_per_image": row["flops_per_image"],
        "mfu": row["mfu"],
        "clock": row["clock"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phg-bench", description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default="build/bench.json")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: PyTorch sees no CUDA device (--device cpu runs on the CPU)")
    card = profiling.card_line() if device.type == "cuda" else f"{device}: no card"
    print(card, flush=True)
    record = run(int(os.environ.get("PHG_BENCH_BATCH", "1024")),
                 int(os.environ.get("PHG_BENCH_STEPS", "60")),
                 os.environ.get("PHG_BENCH_DTYPE", "bfloat16"), device)
    profiling.write_build_json(args.out, {"card": card, **record})
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
