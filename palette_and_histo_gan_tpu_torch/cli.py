"""Command-line trainer of the PyTorch port.

    python -m palette_and_histo_gan_tpu_torch.cli --model indexed \
        --steps 8 --update-steps 4 --synthetic

Flags follow palette_and_histo_gan_tpu/cli.py. It trains on the card
("cuda") unless `--device` names another device ("cpu" for the CPU).

`--data-parallel {auto,on,off}` trains one model over several ranks, one
process a rank, under torchrun:

    torchrun --standalone --nproc-per-node=4 -m palette_and_histo_gan_tpu_torch.cli \
        --model histogram --batch-size 1024 --compute-dtype bfloat16 --data-parallel on

`--batch-size` is the global batch, split over the ranks; under torchrun
`--device cuda` is cuda:LOCAL_RANK, and the ranks join over NCCL (Gloo on
the CPU). "auto" (the default) takes data parallelism when torchrun starts
more than one rank; "on" also forms a world of one without torchrun. Only
rank 0 writes logs, previews, checkpoints and weights. `--callbacks evaluate_fid` reports the train/test FID (eval/fid.py;
PHG_INCEPTION_WEIGHTS names converted pretrained InceptionV3 weights, else
the weights are random).

`--resume` continues from the newest checkpoint under
<temp>/training-checkpoints/ up to `--steps` in all; `--init-generator` /
`--init-discriminator` start from converted reference weights (the Flax
`.npz` of scripts/convert_reference_weights.py) and cannot go with
`--resume`. After training, `--save-weights` writes both networks to
models/py/<which>/<arch>/<model>/params.pt and `--generate-images` one
[Input, Target, Generated] PNG per test pair under
<temp>/generated-images/. `--synthetic` trains on seeded sprites of the
dataset's split sizes, for machines without the dataset: random uint8
pixels for the RGBA variants, few-colour sprites for the indexed variant
(data/loader.py::synthetic_indexed_arrays).

`--histogram-impl` picks the histogram variant's loss path (config.py):
"xla", the plain PyTorch chain; "pallas", the float32 kernels K3a/K4a;
"pallas2", the kernels K3b/K4b in the compute dtype. Its default is
"pallas2" on a CUDA device (the fastest on the card) and "xla" on the CPU,
where every kernel path runs its plain version anyway.
"""

from __future__ import annotations

import argparse

import torch

from .config import (
    DIRECTIONS,
    MODEL_VARIANTS,
    PALETTE_ORDERINGS,
    Config,
    config_for_variant,
)

HISTOGRAM_IMPLS = ("xla", "pallas", "pallas2")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phg-train-torch",
        description="palette-and-histo-gan trainer, PyTorch port",
    )
    p.add_argument("--model", choices=MODEL_VARIANTS, default="baseline-no-aug")
    p.add_argument("--source", choices=DIRECTIONS, default="front")
    p.add_argument("--target", choices=DIRECTIONS, default="right")
    p.add_argument("--palette-ordering", choices=PALETTE_ORDERINGS, default="grayness")
    p.add_argument("--lambda-l1", type=float, default=None)
    p.add_argument("--lambda-histogram", type=float, default=None)
    p.add_argument("--lambda-segmentation", type=float, default=None)
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--steps", type=int, default=None, help="override epoch-derived steps")
    p.add_argument("--update-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--seed", type=int, default=47)
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument(
        "--data-roots", type=str, nargs="+", default=None,
        help="several dataset roots, concatenated in global-index order",
    )
    p.add_argument(
        "--dataset-sizes", type=int, nargs="+", default=None,
        help="one dataset size per root; each splits ceil(0.85 * n) / the rest",
    )
    p.add_argument(
        "--synthetic", action="store_true",
        help="train on seeded synthetic sprites instead of the dataset",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' (the default), 'cuda:N' or 'cpu'; no fallback between them",
    )
    p.add_argument(
        "--down-filters", type=int, nargs=6, default=None,
        help="encoder widths override (default 64 128 256 512 512 512)",
    )
    p.add_argument(
        "--up-filters", type=int, nargs=6, default=None,
        help="decoder widths override (default 512 512 256 128 64 32)",
    )
    p.add_argument(
        "--callbacks", nargs="*", default=[],
        choices=["show_discriminator_output", "evaluate_fid", "evaluate_l1"],
    )
    p.add_argument(
        "--histogram-impl", choices=HISTOGRAM_IMPLS, default=None,
        help="histogram loss path (default: 'pallas2' on a CUDA device, 'xla' on the CPU)",
    )
    p.add_argument("--resume", action="store_true", help="continue from the newest checkpoint")
    p.add_argument(
        "--init-generator", type=str, default=None, metavar="NPZ",
        help="start from converted reference generator weights; not with --resume",
    )
    p.add_argument(
        "--init-discriminator", type=str, default=None, metavar="NPZ",
        help="start from converted reference discriminator weights; not with --resume",
    )
    p.add_argument("--save-weights", action="store_true")
    p.add_argument("--generate-images", action="store_true")
    p.add_argument(
        "--data-parallel", choices=["auto", "on", "off"], default="auto",
        help="data parallelism over torch.distributed ranks (torchrun); "
        "--batch-size is the global batch",
    )
    return p


def histogram_impl(args: argparse.Namespace) -> str:
    """The --histogram-impl flag, or its default for --device."""
    if args.histogram_impl is not None:
        return args.histogram_impl
    return "pallas2" if torch.device(args.device).type == "cuda" else "xla"


def config_from_args(args: argparse.Namespace) -> Config:
    overrides = dict(
        source_direction=DIRECTIONS.index(args.source),
        target_direction=DIRECTIONS.index(args.target),
        palette_ordering=args.palette_ordering, epochs=args.epochs,
        batch_size=args.batch_size, seed=args.seed, compute_dtype=args.compute_dtype,
        histogram_impl=histogram_impl(args), data_parallel=args.data_parallel,
    )
    for name in ("lambda_l1", "lambda_histogram", "lambda_segmentation", "data_root"):
        if getattr(args, name) is not None:
            overrides[name] = getattr(args, name)
    if args.down_filters is not None:
        overrides["down_filters"] = tuple(args.down_filters)
    if args.up_filters is not None:
        overrides["up_filters"] = tuple(args.up_filters)
    if args.data_roots is not None:
        overrides["data_roots"] = tuple(args.data_roots)
        sizes = args.dataset_sizes
        if sizes is None and len(args.data_roots) != 1:
            raise SystemExit(
                f"--data-roots got {len(args.data_roots)} roots but "
                "--dataset-sizes was not given; pass one size per root"
            )
        if sizes is not None and len(sizes) != len(args.data_roots):
            raise SystemExit(
                f"--data-roots ({len(args.data_roots)}) and --dataset-sizes "
                f"({len(sizes)}) must have the same length"
            )
    if args.dataset_sizes is not None:
        overrides["dataset_sizes"] = tuple(args.dataset_sizes)
    return config_for_variant(args.model, **overrides)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.resume and (args.init_generator or args.init_discriminator):
        raise SystemExit(
            "--resume and --init-generator/--init-discriminator are mutually "
            "exclusive (a checkpoint restore would overwrite the import)"
        )
    config = config_from_args(args)

    from .data import loader
    from .parallel import distributed
    from .train.trainer import Trainer

    device = distributed.rank_device(args.device)
    datasets = None
    if args.synthetic:
        if config.is_indexed:
            datasets = loader.indexed_datasets_from_arrays(
                *loader.synthetic_indexed_arrays(config, args.seed), device,
                config.palette_ordering, config.seed,
            )
        else:
            datasets = loader.datasets_from_arrays(
                *loader.synthetic_arrays(config, args.seed), device
            )
    joined = torch.distributed.is_initialized()
    try:
        return train(args, config, Trainer(config, device, datasets=datasets))
    finally:
        if not joined:  # leave a process group the trainer formed
            distributed.shutdown()


def train(args: argparse.Namespace, config: Config, trainer) -> int:
    """Restore or import, fit, then write what the flags ask for."""
    starting_step = 0
    if args.resume:
        starting_step = trainer.restore_latest_checkpoint()
        trainer.say(f"Resumed from step {starting_step}")
    if args.init_generator or args.init_discriminator:
        trainer.import_network_params(args.init_generator, args.init_discriminator)
        trainer.say("Imported converted reference weights")
    steps = args.steps if args.steps is not None else config.steps
    update_steps = args.update_steps if args.update_steps is not None else config.update_steps
    parallel = "one device"
    if trainer.group is not None:
        parallel = (f"data parallel, {torch.distributed.get_backend()} x "
                    f"{trainer.group.world_size} ranks, batch "
                    f"{config.batch_size // trainer.group.world_size} a rank")
    trainer.say(
        f"Starting training for {config.model} ({config.architecture_name}) on "
        f"{trainer.device}: {steps} steps, updating every {update_steps}, "
        f"histogram_impl {config.histogram_impl}, {parallel}..."
    )
    trainer.fit(steps - starting_step, update_steps, callbacks=list(args.callbacks),
                starting_step=starting_step)
    if args.save_weights:
        trainer.save_generator()
        trainer.save_discriminator()
    if args.generate_images:
        trainer.generate_images_from_dataset("test")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
