"""Serving: export a generator program, then run it with no model code.

Counterpart of examples/serve_exported.py. Two commands:

    # export a generator program (fresh init, or --checkpoint to restore
    # the newest checkpoint of <temp>/training-checkpoints/ first)
    python -m palette_and_histo_gan_tpu_torch.serve export \
        --model baseline-no-aug --batch-size 16 --out program.pt2

    # translate a folder of RGBA PNGs through the program
    python -m palette_and_histo_gan_tpu_torch.serve serve \
        --program program.pt2 --input-dir sprites/ --output-dir generated/

`serve` uses only models/export.py::load_exported: the program runs on the
device it was exported on (`--device` of `export`, the card by default).
An exported program has a fixed batch: the last batch is padded with
copies of its first image and the padding is dropped. Outputs are
quantized as ((fake + 1) * 127.5) clipped to [0, 255] and truncated, and
written as RGBA PNGs under the input files' names.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import MODEL_VARIANTS, config_for_variant
from .models import export as export_mod
from .native import png_io
from .utils import visualization as viz


def do_export(args) -> None:
    from .train import checkpoint as ckpt
    from .train.state import create_train_state

    config = config_for_variant(args.model, batch_size=args.batch_size)
    state = create_train_state(config, args.device, config.seed)
    if args.checkpoint:
        manager = ckpt.make_manager(config)
        if manager.latest_step() is None:
            raise SystemExit(f"no checkpoint under {manager.directory}")
        print(f"restored the checkpoint of step {manager.restore(state).step}")
    program = export_mod.export_generator(config, state.generator, args.batch_size)
    torch.export.save(program, args.out)
    print(f"exported the {args.model} generator ({os.path.getsize(args.out)} bytes) "
          f"-> {args.out}")


def read_sources(input_dir: str, height: int, width: int) -> tuple[list[str], np.ndarray]:
    """The sorted PNG names of a folder and their images as (N, H, W, 4)
    float32 in [-1, 1] (dataset_utils.py:39-48)."""
    names = sorted(f for f in os.listdir(input_dir) if f.lower().endswith(".png"))
    if not names:
        raise SystemExit(f"no PNGs in {input_dir}")
    images = []
    for name in names:
        img = png_io.decode_png_rgba(os.path.join(input_dir, name), height, width)
        if img is None:
            raise SystemExit(f"{name}: not a {height}x{width} PNG the native decoder reads")
        images.append(img)
    return names, np.stack(images).astype(np.float32) / 127.5 - 1.0


def padded_batches(source: np.ndarray, batch: int):
    """(chunk, n_real) for each run of `batch` images; the last chunk is
    filled up with copies of its first image (examples/serve_exported.py:
    100-106), whose outputs the caller drops."""
    for lo in range(0, len(source), batch):
        chunk = source[lo:lo + batch]
        n_real = len(chunk)
        if n_real < batch:
            chunk = np.concatenate([chunk, np.repeat(chunk[:1], batch - n_real, 0)])
        yield chunk, n_real


def do_serve(args) -> int:
    infer = export_mod.load_exported(args.program)
    batch, height, width, channels = export_mod.input_shape(infer)
    if channels != 4:
        raise SystemExit(
            f"program expects {channels}-channel input, not RGBA: this "
            "demo serves RGBA-variant generators only (an indexed-variant "
            "program consumes palette-index maps and emits 256-way "
            "probabilities, which need per-image palettes to decode — see "
            "train/steps.py::generate for that path)"
        )
    device = next(infer.parameters()).device
    names, source = read_sources(args.input_dir, height, width)
    os.makedirs(args.output_dir, exist_ok=True)
    done = 0
    for chunk, n_real in padded_batches(source, batch):
        with torch.inference_mode():
            fake = infer(torch.from_numpy(chunk).to(device)).float().cpu().numpy()[:n_real]
        fake_u8 = ((fake + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        for img in fake_u8:
            viz._write_png(img, os.path.join(args.output_dir, names[done]))
            done += 1
    print(f"served {len(names)} images -> {args.output_dir}")
    return len(names)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phg-serve-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("export")
    pe.add_argument("--model", choices=MODEL_VARIANTS, default="baseline-no-aug")
    pe.add_argument("--batch-size", type=int, default=16)
    pe.add_argument("--checkpoint", action="store_true",
                    help="restore the newest checkpoint of the model first")
    pe.add_argument("--out", default="program.pt2")
    pe.add_argument("--device", default="cuda",
                    help="'cuda' (the default), 'cuda:N' or 'cpu': where the program runs")
    ps = sub.add_parser("serve")
    ps.add_argument("--program", required=True)
    ps.add_argument("--input-dir", required=True)
    ps.add_argument("--output-dir", default="generated")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "export":
        do_export(args)
    else:
        do_serve(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
