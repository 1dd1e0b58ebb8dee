"""L1 evaluation of every variant.

Mirrors palette_and_histo_gan_tpu/eval/metrics.py:36-122: the generator,
with dropout active as the reference always runs it, translates the first
`num_images` sources of each split in one batched call (train/steps.py::
generate). RGBA variants: mean |fake - real| on the [-1, 1] scale. Indexed:
both index maps decoded through the pair's palette, mean |fake - real| on
the [0, 255] RGBA scale. `generate_fn` is train/steps.py::generate or,
under data parallelism, parallel/dp.py::make_dp_generate_fn's (JAX:
`gen_fn=`).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..data.loader import IndexedDataset, RgbaDataset
from ..ops.image import normalize
from ..ops.palette import indexed_to_rgba
from ..train.steps import generate


def evaluate_l1(real_images: torch.Tensor, fake_images: torch.Tensor) -> torch.Tensor:
    """mean |fake - real| (reference pix2pix_model.py:124-125)."""
    return torch.mean(torch.abs(fake_images - real_images))


@torch.no_grad()
def generate_split_rgba(config: Config, generator, ds: RgbaDataset, num_images: int,
                        dropout_generator: torch.Generator, generate_fn=generate):
    """(real, fake) [-1, 1] tensors for the first `num_images` of a split."""
    src = normalize(ds.sources[:num_images].float())
    real = normalize(ds.targets[:num_images].float())
    return real, generate_fn(config, generator, src, dropout_generator)


@torch.no_grad()
def generate_split_indexed(config: Config, generator, ds: IndexedDataset, num_images: int,
                           dropout_generator: torch.Generator, generate_fn=generate):
    """(real, fake) float32 RGBA on the [0, 255] scale for the first
    `num_images` of a split, decoded through each pair's palette."""
    fake_idx = generate_fn(config, generator, ds.sources[:num_images], dropout_generator)
    palettes = ds.palettes[:num_images]
    return (
        indexed_to_rgba(ds.targets[:num_images], palettes).float(),
        indexed_to_rgba(fake_idx, palettes).float(),
    )


def generate_split(config: Config, generator, ds, num_images: int,
                   dropout_generator: torch.Generator, generate_fn=generate):
    split = generate_split_indexed if config.is_indexed else generate_split_rgba
    return split(config, generator, ds, num_images, dropout_generator, generate_fn)


def report_l1(config: Config, generator, train_ds, test_ds, num_images: int,
              seed: int, generate_fn=generate) -> tuple[float, float]:
    """(train_l1, test_l1) over the first num_images of each split; the
    dropout masks come from a generator seeded with `seed`."""
    drop = torch.Generator(device=train_ds.sources.device)
    drop.manual_seed(seed)
    values = []
    for ds in (train_ds, test_ds):
        real, fake = generate_split(config, generator, ds, num_images, drop, generate_fn)
        values.append(float(evaluate_l1(real, fake)))
    return values[0], values[1]
