"""Device-resident data: decode once, keep the uint8 splits on the device,
sample per epoch on the device.

Mirrors palette_and_histo_gan_tpu/data/loader.py (RGBA part): the PNGs of
<root>/<train|test>/<i-direction>/<n>.png decode once at start-up through
the JAX package's ctypes decoder (`palette_and_histo_gan_tpu.native.png_io`,
no JAX) or PIL; transparent pixels are blackened once; the splits stay on
the device as uint8 and the train step gathers its batch there.
`datasets_from_arrays` hands the Trainer arrays that are already in memory.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from palette_and_histo_gan_tpu.config import DIRECTION_FOLDERS

from ..config import Config


def _decode_png(path: str) -> np.ndarray:
    from palette_and_histo_gan_tpu.native import png_io

    arr = png_io.decode_png_rgba(path)
    if arr is not None:
        return arr
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def load_split_arrays(data_root: str, split: str, direction: int, n: int) -> np.ndarray:
    """The n images of one pose of a split as (n, 64, 64, 4) uint8."""
    from palette_and_histo_gan_tpu.native import png_io

    folder = os.path.join(data_root, split, DIRECTION_FOLDERS[direction])
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"no dataset folder {folder}; set --data-root / config.data_root "
            "(the rpg-maker-xp dataset is not in this repository)"
        )
    batch = png_io.decode_folder(folder, n)
    if batch is not None:
        return batch
    return np.stack([_decode_png(os.path.join(folder, f"{i}.png")) for i in range(n)])


def load_concat_split(config: Config, split: str, direction: int) -> np.ndarray:
    """One pose of a split across all configured roots, in global-index order."""
    sizes = config.train_sizes if split == "train" else config.test_sizes
    parts = [
        load_split_arrays(root, split, direction, n)
        for root, n in zip(config.effective_data_roots, sizes)
    ]
    return np.concatenate(parts, axis=0)


def prepare_rgba(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] with fully transparent pixels blackened."""
    return np.where(images_u8[..., 3:4] == 0, np.uint8(0), images_u8)


class RgbaDataset(NamedTuple):
    """A split resident on the device: uint8 [0, 255], blackened."""

    sources: torch.Tensor  # (N, 64, 64, 4) uint8
    targets: torch.Tensor  # (N, 64, 64, 4) uint8

    @property
    def n(self) -> int:
        return self.sources.shape[0]


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(prepare_rgba(arr))).to(device)


def datasets_from_arrays(
    train_sources, train_targets, test_sources, test_targets, device
) -> tuple[RgbaDataset, RgbaDataset]:
    """(train, test) splits on `device` from (N, 64, 64, 4) uint8 arrays."""
    arrays = (train_sources, train_targets, test_sources, test_targets)
    for a in arrays:
        if a.dtype != np.uint8 or a.shape[1:] != (64, 64, 4):
            raise ValueError(f"expected uint8 (N, 64, 64, 4), got {a.dtype} {a.shape}")
    ts, tt, es, et = (_to_device(a, device) for a in arrays)
    return RgbaDataset(ts, tt), RgbaDataset(es, et)


def make_rgba_datasets(config: Config, device) -> tuple[RgbaDataset, RgbaDataset]:
    """(train, test) splits decoded from config's dataset roots, on `device`."""
    split = {
        (s, d): load_concat_split(config, s, d)
        for s in ("train", "test")
        for d in (config.source_direction, config.target_direction)
    }
    src, tgt = config.source_direction, config.target_direction
    return datasets_from_arrays(
        split["train", src], split["train", tgt], split["test", src], split["test", tgt],
        device,
    )


def synthetic_arrays(config: Config, seed: int):
    """Random uint8 sprites of the configured split sizes, made from `seed`:
    (train_sources, train_targets, test_sources, test_targets)."""
    rng = np.random.default_rng(seed)
    n_train, n_test = config.train_size, sum(config.test_sizes)
    return tuple(
        rng.integers(0, 256, (n, 64, 64, 4), dtype=np.uint8)
        for n in (n_train, n_train, n_test, n_test)
    )


def batch_indices(
    data_seed: int, step: int, n: int, batch_size: int, device
) -> torch.Tensor:
    """Indices of the batch at a global step: a fresh permutation of the n
    examples each epoch, drawn on `device` from a generator seeded by
    (data_seed, epoch) and consumed in order. The last batch of an epoch
    wraps around to the epoch's first examples (loader.py:197-213)."""
    steps_per_epoch = -(-n // batch_size)
    epoch, batch_in_epoch = divmod(step, steps_per_epoch)
    gen = torch.Generator(device=device)
    gen.manual_seed((data_seed << 32) + epoch)
    perm = torch.randperm(n, generator=gen, device=device)
    flat = (batch_in_epoch * batch_size + torch.arange(batch_size, device=device)) % n
    return perm[flat]
