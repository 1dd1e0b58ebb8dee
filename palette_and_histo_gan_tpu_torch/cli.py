"""Command-line trainer of the PyTorch port.

    python -m palette_and_histo_gan_tpu_torch.cli --model indexed \
        --steps 8 --update-steps 4 --synthetic

Flags follow palette_and_histo_gan_tpu/cli.py where the port has the
feature. It trains on the card ("cuda") unless `--device` names another
device ("cpu" for the CPU). `--synthetic` trains on seeded sprites of the
dataset's split sizes, for machines without the dataset: random uint8
pixels for the RGBA variants, few-colour sprites for the indexed variant
(data/loader.py::synthetic_indexed_arrays).
"""

from __future__ import annotations

import argparse

from .config import MODEL_VARIANTS, PALETTE_ORDERINGS, config_for_variant, set_f32_parity_mode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phg-train-torch",
        description="palette-and-histo-gan trainer, PyTorch port",
    )
    p.add_argument("--model", choices=MODEL_VARIANTS, default="baseline-no-aug")
    p.add_argument("--palette-ordering", choices=PALETTE_ORDERINGS, default="grayness")
    p.add_argument("--lambda-segmentation", type=float, default=None)
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--steps", type=int, default=None, help="override epoch-derived steps")
    p.add_argument("--update-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--seed", type=int, default=47)
    p.add_argument("--data-root", type=str, default=None)
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
    p.add_argument("--callbacks", nargs="*", default=[], choices=["evaluate_l1"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    overrides = dict(
        palette_ordering=args.palette_ordering, epochs=args.epochs,
        batch_size=args.batch_size, seed=args.seed, compute_dtype=args.compute_dtype,
    )
    if args.lambda_segmentation is not None:
        overrides["lambda_segmentation"] = args.lambda_segmentation
    if args.data_root is not None:
        overrides["data_root"] = args.data_root
    if args.down_filters is not None:
        overrides["down_filters"] = tuple(args.down_filters)
    if args.up_filters is not None:
        overrides["up_filters"] = tuple(args.up_filters)
    config = config_for_variant(args.model, **overrides)
    if config.compute_dtype == "float32":
        # float32 means the reference's float32: no TF32 convolutions
        set_f32_parity_mode()

    from .data import loader
    from .train.trainer import Trainer

    datasets = None
    if args.synthetic:
        if config.is_indexed:
            datasets = loader.indexed_datasets_from_arrays(
                *loader.synthetic_indexed_arrays(config, args.seed), args.device,
                config.palette_ordering, config.seed,
            )
        else:
            datasets = loader.datasets_from_arrays(
                *loader.synthetic_arrays(config, args.seed), args.device
            )
    trainer = Trainer(config, args.device, datasets=datasets)
    steps = args.steps if args.steps is not None else config.steps
    update_steps = args.update_steps if args.update_steps is not None else config.update_steps
    print(
        f"Starting training for {config.model} ({config.architecture_name}) on "
        f"{trainer.device}: {steps} steps, updating every {update_steps}..."
    )
    trainer.fit(steps, update_steps, callbacks=list(args.callbacks))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
