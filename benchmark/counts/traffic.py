"""The one generator of the benchmark's data, read from a traffic mix
(traffic/<name>.json) and a configuration (configs/<name>.json).

The rule is the repository's sweep's (palette_and_histo_gan_tpu_torch/
sweep.py::synthetic_data): uniform uint8 RGBA pairs (n, 64, 64, 4) for the
RGBA variants, uniform int32 palette-index maps (n, 64, 64, 1) in 0-255 for
the indexed variant. Here they are drawn on the device from the run's seed
with a torch.Generator, in one call a tensor, and the RGBA pixels with
alpha 0 are blackened as the loader blackens them
(palette_and_histo_gan_tpu_torch/data/loader.py::prepare_rgba).

`sub_seeds` splits the run's --seed (any whole number) into the seeds of
the data, the weights, the epoch sampler, the augmentation draws and the
dropout masks, each under 2**31.
"""

from __future__ import annotations

import numpy as np
import torch

SIDE = 64
SEED_NAMES = ("data", "weights", "sampler", "augment", "dropout")


def sub_seeds(seed: int) -> dict:
    words = np.random.SeedSequence(abs(int(seed))).generate_state(len(SEED_NAMES), np.uint32)
    return {name: int(w) >> 1 for name, w in zip(SEED_NAMES, words)}


def data_kind(config: dict) -> str:
    return "index_maps" if config["network"]["generator_in_channels"] == 1 else "rgba"


def make_pairs(kind: str, n: int, generator: torch.Generator) -> tuple:
    """(sources, targets) of n pairs on the generator's device."""
    device = generator.device
    if kind == "index_maps":
        return tuple(torch.randint(0, 256, (n, SIDE, SIDE, 1), generator=generator,
                                   device=device, dtype=torch.int32) for _ in range(2))
    out = []
    for _ in range(2):
        x = torch.randint(0, 256, (n, SIDE, SIDE, 4), generator=generator, device=device,
                          dtype=torch.uint8)
        out.append(torch.where(x[..., 3:4] == 0, torch.zeros_like(x), x))
    return tuple(out)


def make_splits(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"train": (sources, targets), "test": (sources, targets) or None} of
    the traffic's `train_pairs` and `test_pairs`, drawn from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kind = data_kind(config)
    train = make_pairs(kind, traffic["train_pairs"], gen)
    test = make_pairs(kind, traffic["test_pairs"], gen) if traffic.get("test_pairs") else None
    return {"train": train, "test": test}
