"""The measured-baseline protocol: the paper's four configurations at the
reference's hyperparameters and schedule, with L1, FID and the phases' seconds.

    python -m palette_and_histo_gan_tpu_torch.measure_baseline [--epochs 160] \
        [--variants baseline-no-aug baseline indexed histogram] [--no-fid] \
        [--data-root DIR] [--out build/baseline_results.json] \
        [--temp-folder build/measure_baseline] [--device cuda|cpu]

The counterpart of `scripts/measure_baseline.py`. Each variant trains
through the port's `train/trainer.py::Trainer.fit` with the "evaluate_l1"
callback, `epochs` x 63 steps at batch 4 float32 (10,080 at the
reference's 160 epochs), with the Trainer's lifecycle as it is: a preview
and an L1 report every `update_steps` (steps / 40), a checkpoint every five
of them and at the end. Then `report_l1()` and, unless `--no-fid`,
`report_fid()`, one `eval/fid.py::FidEvaluator` shared by the variants (on
random InceptionV3 weights unless PHG_INCEPTION_WEIGHTS names converted
ones: such FIDs compare only between runs of this port).

An entry has the keys of `baseline_results.json`'s (variant, architecture,
steps, batch_size, train_seconds, steps_per_second, l1_train, l1_test,
phase_seconds, fid_train, fid_test, fid_weights), unrounded, and adds
`data_root`, `histogram_impl` ("pallas2" on a card, as the CLI picks it),
the peak device memory of the run and the kernels' launches in it (the
dataset build's included). Float32 runs with TF32 off (the Trainer's
`config.py::float32_exact`).

Under `torchrun --nproc-per-node=N -m palette_and_histo_gan_tpu_torch.
measure_baseline ...` each rank runs on its card (cuda:LOCAL_RANK) and the
ranks train as one data-parallel group: the JAX script's mesh rule, here
the Trainer's (`train/trainer.py::data_group`: a group when the world has
more than one rank, which raises unless the global batch of 4 splits over
it). The shared FidEvaluator shards its forwards over that group. Only
rank 0 prints and writes the record, whose `world_size` is N; its
`train_seconds`, `peak_device_memory_bytes` and `launches` are rank 0's.
Run as one process, it trains on one device as before (`world_size` 1).
It runs on `cuda` unless `--device cpu` is given, prints the card's line
first and writes its record only under `build/`; the Trainer's previews and
checkpoints go under `--temp-folder`.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

from .config import config_for_variant, default_data_root
from .parallel import distributed
from .sweep import default_histogram_impl, launches_since, read_launches
from .utils import profiling

VARIANTS = ("baseline-no-aug", "baseline", "indexed", "histogram")
TEMP_FOLDER = os.path.join("build", "measure_baseline")


def fid_weights() -> str:
    """Which InceptionV3 weights the FID report runs on."""
    if os.environ.get("PHG_INCEPTION_WEIGHTS"):
        return "pretrained"
    return "random-init (no pretrained weights in the repository)"


def run_variant(variant: str, epochs: int, eval_fid: bool, fid_evaluator, device,
                data_root: str | None = None, temp_folder: str = TEMP_FOLDER,
                **config_kw) -> dict:
    """Train `variant` for `epochs` through Trainer.fit on `device` from the
    dataset root `data_root` (default: default_data_root()) and report its
    L1 and, with `eval_fid`, its FID through `fid_evaluator`. `config_kw`
    may narrow the networks."""
    from .train.trainer import Trainer

    device = torch.device(device)
    on_card = device.type == "cuda"
    config = config_for_variant(
        variant, epochs=epochs, data_root=default_data_root() if data_root is None else data_root,
        histogram_impl=default_histogram_impl(device), temp_folder=temp_folder, **config_kw)
    before = read_launches()  # the indexed dataset build launches K5
    trainer = Trainer(config, device, fid_evaluator=fid_evaluator)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.fit(callbacks=["evaluate_l1"])
    train_time = time.perf_counter() - t0
    launches = launches_since(before)

    l1_train, l1_test = trainer.report_l1()
    result = {
        "variant": variant,
        "architecture": config.architecture_name,
        "steps": config.steps,
        "batch_size": config.batch_size,
        "train_seconds": train_time,
        "steps_per_second": config.steps / train_time,
        "l1_train": l1_train,
        "l1_test": l1_test,
        "phase_seconds": dict(trainer.phase_seconds),
    }
    if eval_fid:
        result["fid_train"], result["fid_test"] = trainer.report_fid()
        result["fid_weights"] = fid_weights()
    result.update(
        data_root=config.data_root, histogram_impl=config.histogram_impl,
        peak_device_memory_bytes=torch.cuda.max_memory_allocated(device) if on_card else None,
        launches=launches,
    )
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-measure-baseline", description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--variants", nargs="*", choices=VARIANTS, default=list(VARIANTS))
    p.add_argument("--no-fid", action="store_true")
    p.add_argument("--data-root", default=None, help="default: $PHG_DATA_ROOT or "
                   "datasets/rpg-maker-xp")
    p.add_argument("--out", default="build/baseline_results.json")
    p.add_argument("--temp-folder", default=TEMP_FOLDER,
                   help="where the Trainer writes its previews and checkpoints")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def measure(variants, epochs: int, device, eval_fid: bool = True, data_root: str | None = None,
            temp_folder: str = TEMP_FOLDER, out: str | None = None, fid_input_size: int = 299,
            **config_kw) -> dict:
    """The record of `variants` trained for `epochs` each on `device`, or on
    this rank's device of the data-parallel group that the Trainer's rule
    forms (`data_group`, on the first variant's config), with one
    FidEvaluator shared by the variants (sharded over the group). The
    writing process (the one process, or rank 0) prints, and writes the
    record to `out` under build/ when given. `config_kw` may narrow the
    networks; `fid_input_size` shrinks the Inception's input (tests)."""
    from .eval.fid import FidEvaluator
    from .train.trainer import data_group

    device = distributed.rank_device(device)
    probe = config_for_variant(variants[0], epochs=epochs, **config_kw)
    group = data_group(probe, device)
    if group is not None:
        device = group.device
    writes = group is None or group.rank == 0
    card = profiling.card_line() if device.type == "cuda" else f"{device}: no card"
    if writes:
        print(card, flush=True)
    fid_evaluator = (FidEvaluator(input_size=fid_input_size, device=device, group=group)
                     if eval_fid else None)
    results = []
    for variant in variants:
        if writes:
            print(f"=== {variant} ===", flush=True)
        results.append(run_variant(variant, epochs, eval_fid, fid_evaluator, device, data_root,
                                   temp_folder, **config_kw))
        if writes:
            print(json.dumps(results[-1], indent=2), flush=True)
    record = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "card": card,
        "epochs": epochs,
        "world_size": 1 if group is None else group.world_size,
        "results": results,
    }
    if writes and out is not None:
        print(f"wrote {profiling.write_build_json(out, record)}", flush=True)
    return record


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("measure_baseline: PyTorch sees no CUDA device "
                         "(--device cpu runs on the CPU)")
    try:
        measure(args.variants, args.epochs, device, not args.no_fid, args.data_root,
                args.temp_folder, args.out)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
