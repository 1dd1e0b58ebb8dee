"""Device-resident data: one-time PNG decode, uint8 splits on the device,
per-epoch sampling."""

from .loader import (
    RgbaDataset,
    batch_indices,
    datasets_from_arrays,
    load_concat_split,
    load_split_arrays,
    make_rgba_datasets,
    prepare_rgba,
    synthetic_arrays,
)

__all__ = [
    "RgbaDataset",
    "batch_indices",
    "datasets_from_arrays",
    "load_concat_split",
    "load_split_arrays",
    "make_rgba_datasets",
    "prepare_rgba",
    "synthetic_arrays",
]
