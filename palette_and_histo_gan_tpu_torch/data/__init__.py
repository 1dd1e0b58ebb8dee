"""Device-resident data: one-time PNG decode, uint8 splits (RGBA) or index
maps and palettes (indexed) on the device, per-epoch sampling."""

from .loader import (
    IndexedDataset,
    RgbaDataset,
    batch_indices,
    datasets_from_arrays,
    gather_indexed_batch,
    indexed_datasets_from_arrays,
    load_concat_split,
    load_split_arrays,
    load_split_pairs,
    make_indexed_datasets,
    make_rgba_datasets,
    prepare_rgba,
    synthetic_arrays,
    synthetic_indexed_arrays,
)

__all__ = [
    "IndexedDataset",
    "RgbaDataset",
    "batch_indices",
    "datasets_from_arrays",
    "gather_indexed_batch",
    "indexed_datasets_from_arrays",
    "load_concat_split",
    "load_split_arrays",
    "load_split_pairs",
    "make_indexed_datasets",
    "make_rgba_datasets",
    "prepare_rgba",
    "synthetic_arrays",
    "synthetic_indexed_arrays",
]
