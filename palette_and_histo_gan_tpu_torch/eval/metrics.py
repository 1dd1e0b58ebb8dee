"""L1 evaluation of the RGBA variants.

Mirrors palette_and_histo_gan_tpu/eval/metrics.py:36-122: the generator,
with dropout active as the reference always runs it, translates the first
`num_images` sources of each split in one batched call, and the metric is
mean |fake - real| on the [-1, 1] scale.
"""

from __future__ import annotations

import torch

from ..data.loader import RgbaDataset
from ..ops.image import normalize


def evaluate_l1(real_images: torch.Tensor, fake_images: torch.Tensor) -> torch.Tensor:
    """mean |fake - real| (reference pix2pix_model.py:124-125)."""
    return torch.mean(torch.abs(fake_images - real_images))


@torch.no_grad()
def generate_split_rgba(generator, ds: RgbaDataset, num_images: int,
                        dropout_generator: torch.Generator):
    """(real, fake) [-1, 1] tensors for the first `num_images` of a split."""
    src = normalize(ds.sources[:num_images].float())
    real = normalize(ds.targets[:num_images].float())
    return real, generator(src, dropout_generator)


def report_l1(generator, train_ds: RgbaDataset, test_ds: RgbaDataset,
              num_images: int, seed: int) -> tuple[float, float]:
    """(train_l1, test_l1) over the first num_images of each split; the
    dropout masks come from a generator seeded with `seed`."""
    drop = torch.Generator(device=train_ds.sources.device)
    drop.manual_seed(seed)
    values = []
    for ds in (train_ds, test_ds):
        real, fake = generate_split_rgba(generator, ds, num_images, drop)
        values.append(float(evaluate_l1(real, fake)))
    return values[0], values[1]
