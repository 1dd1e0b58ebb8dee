"""The shared regime of the measured training-quality comparison.

    python -m palette_and_histo_gan_tpu_torch.ref_regime [--write-synthetic-root DIR]
        [--data-root DIR] [--device cuda|cpu]

The counterpart of `scripts/ref_regime.py`: what every side of the
comparison (the TF reference, the JAX build, this port) must agree on, so
that the framework under test is the only difference between them.

  * Reference-faithful init (`reference_init`): conv kernels N(0, 0.02)
    drawn from a generator seeded with `zlib.crc32` of the weight's
    canonical name (the draw of `tests/parity_utils.py::make_param`, of
    which this module keeps its own copy), biases and offsets 0, norm
    scales 1. The specs are `models/convert.py::generator_weight_spec` and
    `::discriminator_weight_spec`.
  * Dropout off (`deterministic_dropout=True` on the caller's side).
  * Batch order (`batch_order`): per-epoch permutations of the train split
    from one numpy Generator seeded with SEED (47), drop-remainder (62
    full batches of 4 per 250-image epoch).
  * Eval: L1 over the 44-image test split with the deterministic
    generator; the indexed variant's on the palette-decoded [0, 255]
    images (`decode_indexed`, out-of-range labels clamped).
  * FID: the reference's preprocessing (`fid_preprocess`) and its scipy
    formula (`reference_fid_from_acts`), at FID_STEPS of the reference's
    10,080-step schedule.

The splits are decoded from a dataset root in the sprites' layout
(<root>/<train|test>/<i-direction>/<n>.png): `root` is an explicit
argument that defaults to `config.py::default_data_root()`. The sprites
are not in the repository; `--write-synthetic-root DIR` writes a seeded
stand-in of that layout (`write_synthetic_root`: 250 train / 44 test pairs
of few-colour sprites, `data/loader.py::synthetic_indexed_arrays`) on
which the regime's tools run as they would on the sprites. Its L1 and FID
are plumbing checks, not quality. The command then prints what the tools
will read from the root (`summary`: the split sizes, the indexed splits
built on the device, K5 on a card, and their labels past 255); it runs on
`cuda` unless `--device cpu` is given and prints the card's line first.

Every function here gives the arrays the JAX script gives on the same
inputs, bit for bit (tests/test_torch_ref_regime.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

import numpy as np
import torch

from .config import DIRECTION_FOLDERS, SEED, config_for_variant, default_data_root
from .eval.fid import preprocess_input, scale_images_nn

BATCH = 4
FID_STEPS = (2520, 5040, 10080)  # a quarter, half and all of 160 epochs x 63 steps
CONV_STDDEV = 0.02  # the reference's kernel init (networks.py:7)


def make_conv_param(name: str, shape) -> np.ndarray:
    """N(0, 0.02) float32 of `shape` from a generator seeded with the
    crc32 of the canonical `name`."""
    rng = np.random.default_rng(zlib.crc32(name.encode("utf-8")))
    return rng.normal(0.0, CONV_STDDEV, size=shape).astype(np.float32)


def reference_init(spec) -> dict:
    """{name: array} of a (name, shape, kind) weight spec: convs
    N(0, 0.02) keyed by name, biases and offsets 0, scales 1."""
    out = {}
    for name, shape, kind in spec:
        if kind == "conv":
            out[name] = make_conv_param(name, shape)
        elif kind in ("bias", "offset"):
            out[name] = np.zeros(shape, np.float32)
        elif kind == "scale":
            out[name] = np.ones(shape, np.float32)
        else:
            raise ValueError(kind)
    return out


def batch_order(n_train: int, steps: int, batch: int = BATCH) -> np.ndarray:
    """(steps, batch) int64 train-split indices: epoch permutations from one
    Generator seeded with SEED, concatenated, drop-remainder."""
    rng = np.random.default_rng(SEED)
    per_epoch = n_train // batch
    order = []
    while len(order) < steps:
        perm = rng.permutation(n_train)
        for k in range(per_epoch):
            order.append(perm[k * batch: (k + 1) * batch])
            if len(order) == steps:
                break
    return np.asarray(order, np.int64)


def load_splits(root: str | None = None):
    """(train_src, train_tgt, test_src, test_tgt) raw uint8 arrays of the
    front -> right pair decoded from `root` (default: default_data_root())."""
    from .data.loader import load_split_pairs

    root = default_data_root() if root is None else root
    return load_split_pairs(config_for_variant("baseline-no-aug", data_root=root))


def load_indexed_splits(root: str | None = None, device="cpu"):
    """((src, tgt, palettes) train, (src, tgt, palettes) test) as numpy,
    built by the port's indexed dataset pipeline from `root` on `device`
    (kernel K5 on a card)."""
    from .data.loader import make_indexed_datasets

    root = default_data_root() if root is None else root
    train_ds, test_ds = make_indexed_datasets(config_for_variant("indexed", data_root=root),
                                              torch.device(device))

    def host(ds):
        return tuple(t.cpu().numpy() for t in (ds.sources, ds.targets, ds.palettes))

    return host(train_ds), host(test_ds)


def normalize(u8: np.ndarray) -> np.ndarray:
    """[0, 255] uint8 -> [-1, 1] float32 (dataset_utils.py:39-48)."""
    return u8.astype(np.float32) / 127.5 - 1.0


def decode_indexed(idx_maps: np.ndarray, palettes: np.ndarray) -> np.ndarray:
    """(N, 64, 64, 1) index maps -> (N, 64, 64, 4) float32 [0, 255] RGBA
    through each pair's palette, out-of-range labels clamped as
    ops/palette.py::indexed_to_rgba clamps them."""
    idx = np.clip(idx_maps[..., 0], 0, palettes.shape[1] - 1)
    return np.stack([palettes[i][idx[i]] for i in range(idx.shape[0])]).astype(np.float32)


def fid_preprocess(images: np.ndarray) -> np.ndarray:
    """The reference's FID preprocessing of [-1, 1] eval images, on the
    CPU: eval/fid.py's nearest-neighbour resize to (299, 299, 3) with the
    reference's quirks (the channel axis too: RGBA keeps channels 0, 2, 3)
    and its preprocess_input, x / 127.5 - 1, in float32."""
    x = torch.from_numpy(np.array(images, np.float32))
    return preprocess_input(scale_images_nn(x, 299, reference_quirks=True)).numpy()


def reference_fid_from_acts(act1: np.ndarray, act2: np.ndarray) -> float:
    """The reference's FID formula from activations
    (frechet_inception_distance.py:25-41): numpy.cov (rowvar=False,
    ddof=1), scipy's sqrtm, its complex part dropped."""
    from scipy.linalg import sqrtm

    mu1, sigma1 = act1.mean(axis=0), np.cov(act1, rowvar=False)
    mu2, sigma2 = act2.mean(axis=0), np.cov(act2, rowvar=False)
    ssdiff = np.sum((mu1 - mu2) ** 2.0)
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(ssdiff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def parse_fid_at(spec: str) -> list:
    """'2520,5040,10080' -> sorted int list; '' -> []."""
    return sorted(int(s) for s in spec.split(",") if s.strip())


def window_means(values, n_windows: int = 5) -> list:
    """Means over equal windows of steps: the macroscopic summary the
    comparison holds (microscopic trajectories decorrelate)."""
    values = np.asarray(values, np.float64)
    edges = np.linspace(0, len(values), n_windows + 1).astype(int)
    return [float(values[a:b].mean()) for a, b in zip(edges[:-1], edges[1:])]


def write_dataset_root(root: str, config, arrays) -> None:
    """(train_sources, train_targets, test_sources, test_targets) as PNGs
    of config's source and target directions in the dataset's layout,
    <root>/<train|test>/<i-direction>/<n>.png, by the port's stdlib PNG
    writer (no PIL needed)."""
    from .utils.visualization import _write_png

    directions = (config.source_direction, config.target_direction)
    for split, pair in (("train", arrays[:2]), ("test", arrays[2:])):
        for direction, images in zip(directions, pair):
            folder = os.path.join(root, split, DIRECTION_FOLDERS[direction])
            os.makedirs(folder)
            for i, img in enumerate(images):
                _write_png(img, os.path.join(folder, f"{i}.png"))


def write_synthetic_root(root: str) -> str:
    """A stand-in for the sprites at `root`, which must not exist, drawn
    from SEED: the reference's 250 / 44 split sizes of few-colour sprites
    (data/loader.py::synthetic_indexed_arrays), which every variant reads."""
    from .data.loader import synthetic_indexed_arrays

    if os.path.exists(root):
        raise FileExistsError(f"{root} exists; the synthetic root is written only afresh")
    config = config_for_variant("indexed")
    write_dataset_root(root, config, synthetic_indexed_arrays(config, SEED))
    return root


def summary(root: str, device) -> dict:
    """What the regime's tools will read from `root`: the split sizes, the
    indexed splits built on `device` (K5 on a card) with their labels past
    255, and the steps of the reference's schedule in the batch order."""
    train_src, _, test_src, _ = load_splits(root)
    (train_idx, train_tgt_idx, _), _ = load_indexed_splits(root, device)
    order = batch_order(len(train_src), 160 * 63)
    return {
        "data_root": root, "train_pairs": len(train_src), "test_pairs": len(test_src),
        "indexed_labels_past_255": int((train_idx > 255).sum() + (train_tgt_idx > 255).sum()),
        "batch_order_steps": len(order), "batch_order_first": order[0].tolist(),
    }


def main(argv=None) -> int:
    from .utils import profiling

    p = argparse.ArgumentParser(prog="phg-ref-regime", description=__doc__.split("\n")[0])
    p.add_argument("--write-synthetic-root", metavar="DIR",
                   help="write the seeded stand-in root there first, and read it")
    p.add_argument("--data-root", default=None, help="default: $PHG_DATA_ROOT or "
                   "datasets/rpg-maker-xp")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ref_regime: PyTorch sees no CUDA device (--device cpu runs on the CPU)")
    print(profiling.card_line() if device.type == "cuda" else f"{device}: no card", flush=True)
    root = args.data_root
    if args.write_synthetic_root:
        root = write_synthetic_root(args.write_synthetic_root)
    print(json.dumps(summary(default_data_root() if root is None else root, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
