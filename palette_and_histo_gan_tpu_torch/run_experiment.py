"""The reference notebook's experiment end to end on the port.

Counterpart of examples/run_experiment.py (experiments.ipynb, cells 1-17):
choose a variant, load the dataset, build the model, fit with the three
monitoring callbacks (discriminator patch maps, FID, L1), optionally save
the weights, and dump every test image.

    python -m palette_and_histo_gan_tpu_torch.run_experiment --model histogram

`--synthetic` trains on seeded sprites of the dataset's split sizes (for
machines without the dataset) and `--device` picks the device ("cuda" by
default, "cpu"), as in the port's CLI, whose histogram configuration it
takes ("pallas2" on a card); `--steps` / `--update-steps` override the
epoch-derived schedule.
"""

from __future__ import annotations

import argparse

import torch

from .config import DIRECTIONS, MODEL_VARIANTS, config_for_variant

CALLBACKS = ["show_discriminator_output", "evaluate_fid", "evaluate_l1"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-experiment-torch")
    p.add_argument("--model", default="baseline-no-aug", choices=MODEL_VARIANTS)
    p.add_argument("--source", default="front", choices=DIRECTIONS)
    p.add_argument("--target", default="right", choices=DIRECTIONS)
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--steps", type=int, default=None, help="override epoch-derived steps")
    p.add_argument("--update-steps", type=int, default=None)
    p.add_argument("--save-weights", action="store_true")  # cell 12: off by default
    p.add_argument(
        "--generate-all-test-images", action=argparse.BooleanOptionalAction,
        default=True,  # cell 16 runs by default
    )
    p.add_argument("--synthetic", action="store_true",
                   help="train on seeded synthetic sprites instead of the dataset")
    p.add_argument("--device", default="cuda", help="'cuda' (the default), 'cuda:N' or 'cpu'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .data import loader
    from .train.trainer import Trainer

    # cell 1: device check
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Device: {device} ({name}), {torch.cuda.device_count()} CUDA device(s) visible")

    # cells 3/5/9: seed, model choice, per-variant lambdas
    config = config_for_variant(
        args.model,
        source_direction=DIRECTIONS.index(args.source),
        target_direction=DIRECTIONS.index(args.target),
        epochs=args.epochs,
        # the CLI's default: the tensor-core histogram kernels on a card
        histogram_impl="pallas2" if device.type == "cuda" else "xla",
    )
    print(f"Model: {config.model}  architecture: {config.architecture_name}  "
          f"palette ordering: {config.palette_ordering}")

    # cell 7: the dataset, on the device
    datasets = None
    if args.synthetic:
        if config.is_indexed:
            datasets = loader.indexed_datasets_from_arrays(
                *loader.synthetic_indexed_arrays(config, config.seed), device,
                config.palette_ordering, config.seed,
            )
        else:
            datasets = loader.datasets_from_arrays(
                *loader.synthetic_arrays(config, config.seed), device
            )
    trainer = Trainer(config, device, datasets=datasets)

    # cell 10: schedule
    steps = config.steps if args.steps is None else args.steps
    update_steps = config.update_steps if args.update_steps is None else args.update_steps
    print(f"Starting training for {config.epochs} epochs in {steps} steps, "
          f"updating visualization every {update_steps} steps...")

    # cell 12: fit with the three monitoring callbacks
    trainer.fit(steps, update_steps, callbacks=CALLBACKS)

    # cells 14/16: weights (off by default, like the notebook), test images
    if args.save_weights:
        trainer.save_generator()
        trainer.save_discriminator()
    if args.generate_all_test_images:
        trainer.generate_images_from_dataset("test")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
