"""Device-resident data: decode once, keep the splits on the device,
sample per epoch on the device.

Mirrors palette_and_histo_gan_tpu/data/loader.py: the PNGs of
<root>/<train|test>/<i-direction>/<n>.png decode once at start-up through
the port's native decoder (native/png_io.py, built at first use) or, where
it cannot be built, PIL; transparent pixels are blackened once.

  * RGBA variants: the splits stay on the device as uint8 and the train
    step gathers its batch there (`datasets_from_arrays` hands the Trainer
    arrays already in memory).
  * Indexed variant: each source/target pair gets its joint palette on the
    device (ops/palette.py), and kernel K5 turns the sources and the
    targets into int32 index maps against it (two launches a split). The
    maps and palettes stay on the device (`indexed_datasets_from_arrays`).
    Under "shuffled" the palettes' permutations come from a
    `torch.Generator` seeded per split from the config's seed, not from
    `jax.random`: the two packages shuffle differently.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import DIRECTION_FOLDERS, INVALID_INDEX_COLOR, Config
from ..native import png_io
from ..ops import palette as palette_ops


def _decode_png(path: str) -> np.ndarray:
    arr = png_io.decode_png_rgba(path)
    if arr is not None:
        return arr
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def load_split_arrays(data_root: str, split: str, direction: int, n: int) -> np.ndarray:
    """The n images of one pose of a split as (n, 64, 64, 4) uint8."""
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


def _check_arrays(arrays) -> None:
    for a in arrays:
        if a.dtype != np.uint8 or a.shape[1:] != (64, 64, 4):
            raise ValueError(f"expected uint8 (N, 64, 64, 4), got {a.dtype} {a.shape}")


def datasets_from_arrays(
    train_sources, train_targets, test_sources, test_targets, device
) -> tuple[RgbaDataset, RgbaDataset]:
    """(train, test) splits on `device` from (N, 64, 64, 4) uint8 arrays."""
    arrays = (train_sources, train_targets, test_sources, test_targets)
    _check_arrays(arrays)
    ts, tt, es, et = (_to_device(a, device) for a in arrays)
    return RgbaDataset(ts, tt), RgbaDataset(es, et)


def load_split_pairs(config: Config):
    """(train_sources, train_targets, test_sources, test_targets) uint8
    arrays decoded from config's dataset roots."""
    src, tgt = config.source_direction, config.target_direction
    return tuple(
        load_concat_split(config, split, direction)
        for split in ("train", "test")
        for direction in (src, tgt)
    )


def make_rgba_datasets(config: Config, device) -> tuple[RgbaDataset, RgbaDataset]:
    """(train, test) splits decoded from config's dataset roots, on `device`."""
    return datasets_from_arrays(*load_split_pairs(config), device)


class IndexedDataset(NamedTuple):
    """An indexed-colour split resident on the device: per pair its joint
    palette and the index maps of source and target against it."""

    sources: torch.Tensor  # (N, 64, 64, 1) int32
    targets: torch.Tensor  # (N, 64, 64, 1) int32
    palettes: torch.Tensor  # (N, 256, 4) int32

    @property
    def n(self) -> int:
        return self.sources.shape[0]


def indexed_datasets_from_arrays(
    train_sources, train_targets, test_sources, test_targets, device,
    palette_ordering: str = "grayness", seed: int = 0,
) -> tuple[IndexedDataset, IndexedDataset]:
    """(train, test) indexed splits on `device` from (N, 64, 64, 4) uint8
    arrays: transparent pixels blackened, each pair's joint palette, then
    kernel K5 (its plain version on the CPU) on the sources and on the
    targets against the same palettes. "shuffled" draws the train split's
    permutations from a generator seeded 2 * seed and the test split's
    from one seeded 2 * seed + 1."""
    arrays = (train_sources, train_targets, test_sources, test_targets)
    _check_arrays(arrays)
    ts, tt, es, et = (_to_device(a, device) for a in arrays)
    splits = []
    for i, (src, tgt) in enumerate(((ts, tt), (es, et))):
        gen = torch.Generator(device=device)
        gen.manual_seed(2 * seed + i)
        palettes = palette_ops.joint_palettes(src, tgt, palette_ordering, gen)
        splits.append(IndexedDataset(
            palette_ops.rgba_to_indexed(src, palettes),
            palette_ops.rgba_to_indexed(tgt, palettes),
            palettes,
        ))
    return splits[0], splits[1]


def make_indexed_datasets(config: Config, device) -> tuple[IndexedDataset, IndexedDataset]:
    """(train, test) indexed splits decoded from config's dataset roots."""
    return indexed_datasets_from_arrays(
        *load_split_pairs(config), device, config.palette_ordering, config.seed
    )


def gather_indexed_batch(ds: IndexedDataset, idx: torch.Tensor):
    return ds.sources[idx], ds.targets[idx], ds.palettes[idx]


def synthetic_arrays(config: Config, seed: int):
    """Random uint8 sprites of the configured split sizes, made from `seed`:
    (train_sources, train_targets, test_sources, test_targets)."""
    rng = np.random.default_rng(seed)
    n_train, n_test = config.train_size, sum(config.test_sizes)
    return tuple(
        rng.integers(0, 256, (n, 64, 64, 4), dtype=np.uint8)
        for n in (n_train, n_train, n_test, n_test)
    )


def synthetic_indexed_arrays(config: Config, seed: int):
    """Few-colour uint8 sprites of the configured split sizes, made from
    `seed`, for the indexed variant (random pixels would fill every palette
    and index almost every pixel 0): each pair draws its pixels from its
    own pool of 8-48 colours, the first of them transparent (the loader
    blackens it); every 5th pair's pool holds the hotpink filler colour,
    whose pixels index past 255; every 25th pair's source is random pixels,
    more than 256 colours, whose palette truncates."""
    rng = np.random.default_rng(seed)

    def split(n):
        src = np.empty((n, 64, 64, 4), np.uint8)
        tgt = np.empty_like(src)
        for i in range(n):
            k = int(rng.integers(8, 49))
            pool = rng.integers(0, 256, (k, 4), dtype=np.uint8)
            pool[:, 3] = 255
            pool[0, 3] = 0
            if i % 5 == 1:
                pool[1] = INVALID_INDEX_COLOR
            src[i] = pool[rng.integers(0, k, (64, 64))]
            tgt[i] = pool[rng.integers(0, k, (64, 64))]
            if i % 25 == 3:
                src[i] = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        return src, tgt

    n_train, n_test = config.train_size, sum(config.test_sizes)
    return (*split(n_train), *split(n_test))


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
