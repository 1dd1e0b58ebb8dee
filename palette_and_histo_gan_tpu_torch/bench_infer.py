"""Serving throughput of the generator, batched, on the card.

    python -m palette_and_histo_gan_tpu_torch.bench_infer [--variant baseline-no-aug]
        [--batches 64,256,1024] [--steps 16] [--dtype bfloat16] [--deterministic]
        [--out build/bench_infer.json] [--device cuda|cpu]

The counterpart of `scripts/bench_infer.py` (`make_infer_chunk`, `run`,
`main`). The pool of `max(2048, batch)` seeded images stays on the device
(uint8 RGBA, or int32 index maps for the indexed variant). Each iteration
of a chunk gathers `(arange(batch) + i * 8191) % n` from it, so that no
iteration reads the batch of another, normalizes RGBA to [-1, 1]
(`ops/image.py`), runs the generator and adds the float32 sum of the whole
output to an on-device checksum:

  * by default with dropout on, as the reference generates
    (`train/steps.py::generate`, the indexed variant's argmax included),
    the masks drawn from one `torch.Generator` carried through the chunk;
  * with `--deterministic`, with the exported program's semantics
    (`models/export.py::GeneratorInference`, dropout off; for the indexed
    variant the argmax of the logits, as the script takes it of its linear
    head).

The chunk is an eager loop with no host synchronization inside (the
script's `lax.scan`); one fetch of the checksum ends it. Times: the device
clock (`utils/profiling.py::device_step_seconds`, the chunk's device time
a batch) and the host clock around a synchronized chunk; MFU is the
generator forward's FLOPs (`utils/flops.py::_generator_fwd_flops`) over
the card's peak for the dtype. `--device cpu` is a request: `clock:
"host"`, `ms_per_batch` the host clock's, `mfu` null. Prints the card's
line, then a JSON line a batch, and writes `--out` (under `build/`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Callable

import numpy as np
import torch

from .config import MODEL_VARIANTS, Config, config_for_variant, float32_exact
from .ops.image import normalize
from .utils import profiling
from .utils.flops import _generator_fwd_flops
from .utils.roofline import mfu

STRIDE = 8191  # the script's rotating gather
MIN_POOL = 2048
POOL_SEED = 0
WEIGHT_SEED = 0
DROPOUT_SEED = 1
DROPOUT = {False: "on (reference generate quirk)", True: "off (exported-program semantics)"}


def make_pool(config: Config, n: int, device) -> torch.Tensor:
    """n seeded images: uint8 (n, 64, 64, 4), or int32 maps (n, 64, 64, 1)."""
    rng = np.random.default_rng(POOL_SEED)
    if config.is_indexed:
        pool = rng.integers(0, 256, (n, 64, 64, 1)).astype(np.int32)
    else:
        pool = rng.integers(0, 256, (n, 64, 64, 4)).astype(np.uint8)
    return torch.from_numpy(pool).to(device)


def batch_at(config: Config, pool: torch.Tensor, i: int) -> torch.Tensor:
    """Iteration i's source batch: the rotating gather, RGBA normalized."""
    idx = (torch.arange(config.batch_size, device=pool.device) + i * STRIDE) % pool.shape[0]
    src = pool[idx]
    return src if config.is_indexed else normalize(src.float())


def inference_core(config: Config, generator, deterministic: bool) -> Callable:
    """(source, dropout generator) -> the served output."""
    from .models.export import GeneratorInference
    from .train.steps import generate

    if not deterministic:
        return lambda src, drop: generate(config, generator, src, drop)
    if config.is_indexed:

        def core(src, drop):
            logits = generator(src.float(), None, deterministic=True, logits=True)
            return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)

        return core
    served = GeneratorInference(generator)
    return lambda src, drop: served(src)


def make_infer_chunk(config: Config, generator, pool: torch.Tensor,
                     deterministic: bool = False) -> Callable:
    """(dropout generator, num_steps) -> the on-device float32 checksum of
    num_steps batches; the generator advances across the chunk."""
    core = inference_core(config, generator, deterministic)

    @torch.no_grad()
    def infer_chunk(dropout_generator: torch.Generator, num_steps: int) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=pool.device)
        for i in range(num_steps):
            out = core(batch_at(config, pool, i), dropout_generator)
            # the whole output summed, so that no part of it may be skipped
            acc = acc + out.float().sum()
        return acc

    return infer_chunk


def setup(variant: str, batch: int, dtype: str, device, **config_kw):
    """(config, generator from WEIGHT_SEED, resident pool)."""
    from .train.state import build_models

    config = config_for_variant(variant, batch_size=batch, compute_dtype=dtype, **config_kw)
    generator, _ = build_models(config, device, WEIGHT_SEED)
    return config, generator, make_pool(config, max(MIN_POOL, batch), device)


def dropout_generator(device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(DROPOUT_SEED)
    return g


def run(variant: str, batch: int, steps: int, dtype: str = "bfloat16",
        deterministic: bool = False, device="cuda", **config_kw) -> dict:
    """One row: warm up with a chunk of `steps`, then the host clock around
    one chunk and, on a card, the device clock over another."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    config, generator, pool = setup(variant, batch, dtype, device, **config_kw)
    chunk = make_infer_chunk(config, generator, pool, deterministic)
    drop = dropout_generator(device)
    scope = float32_exact if dtype == "float32" else contextlib.nullcontext

    def timed(n):
        with scope():
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            checksum = float(chunk(drop, n))
            return time.perf_counter() - t0, checksum

    timed(steps)  # warm-up: cuDNN plans, the allocator
    host_s, checksum = timed(steps)
    host_s /= steps
    seconds = host_s
    if on_card:
        with scope():
            seconds = profiling.device_step_seconds(lambda n: chunk(drop, n), steps)
    return {
        "variant": variant, "batch": batch, "steps": steps,
        "infer_head_conv": config.infer_head_conv, "dropout": DROPOUT[deterministic],
        "clock": "device" if on_card else "host",
        "ms_per_batch": 1e3 * seconds,
        "images_per_sec": batch / seconds,
        "mfu": mfu(_generator_fwd_flops(config), batch / seconds, dtype) if on_card else None,
        "host_ms_per_batch": 1e3 * host_s,
        "checksum": checksum, "dtype": dtype, "device": str(device),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-bench-infer", description=__doc__.split("\n")[0])
    p.add_argument("--variant", choices=MODEL_VARIANTS, default="baseline-no-aug")
    p.add_argument("--batches", default="64,256,1024")
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--deterministic", action="store_true",
                   help="dropout off (the exported program's semantics) instead of the "
                   "reference's dropout-on generate")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default="build/bench_infer.json")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_infer: PyTorch sees no CUDA device (--device cpu runs on the CPU)")
    card = profiling.card_line() if device.type == "cuda" else f"{device}: no card"
    print(card, flush=True)
    rows = []
    for batch in (int(b) for b in args.batches.split(",")):
        rows.append(run(args.variant, batch, args.steps, args.dtype, args.deterministic,
                        device))
        print(json.dumps(rows[-1]), flush=True)
    path = profiling.write_build_json(args.out, {"card": card, "results": rows})
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
