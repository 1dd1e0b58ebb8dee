"""pix2pix (Isola et al., arXiv:1611.07004) as fegemo/palette-and-histo-gan
trains it, and as palette_and_histo_gan_tpu_torch runs it: the U-Net and
PatchGAN on 64x64 sprites, RGBA pairs or palette-index maps, with the
variant a configuration names under "variant" (histogram, indexed,
baseline, baseline-no-aug).

It names the code that does each part (models/__init__.py lists the
parts): the data of counts/traffic.py, the parameters of reference/nets.py,
the reference steps of reference/step.py (with augment.py, draws.py,
histogram.py, losses.py), the FLOP count of counts/flops.py, the ranges of
the train step's spans in counts/attribution.py. It holds what the harness
hands the program and reads back from it: the port's config
(`config_for_variant` with the configuration file's settings and the
traffic's batch and dtype), its train state with the benchmark's weights
loaded and its augmentation and dropout generators seeded with the
benchmark's seeds, and its losses. KerasAdam's first moment after one
step is (1 - beta1) times the first gradient, beta1 the configuration's:
a program that ran another beta1 reads a first gradient off by the ratio.
"""

from __future__ import annotations

import torch

from ..counts import attribution, flops, traffic
from ..reference import nets, step

SIDE = traffic.SIDE
RANGES = attribution.RANGES
FILLS = {"scale": 1.0, "offset": 0.0, "bias": 0.0}

make_splits = traffic.make_splits
reference_train = step.train


def parameter_shapes(config: dict) -> dict:
    """Every conv kernel N(0, init_std) (the published initializer), norm
    scales 1, norm offsets and biases 0."""
    normal = ("normal", config["network"]["init_std"])
    return {net: [(name, shape, normal if kind == "kernel" else FILLS[kind])
                  for name, shape, kind in items]
            for net, items in nets.parameter_shapes(config).items()}


def flops_per_image(config: dict) -> float:
    return flops.train_step_flops_per_image(flops.Arch.of(config))


def port_config(cell, seeds: dict):
    from palette_and_histo_gan_tpu_torch.config import config_for_variant

    t = cell.traffic
    kw = dict(cell.config["settings"])
    kw.update(batch_size=t["batch_size"], compute_dtype=t["compute_dtype"],
              seed=seeds["sampler"])
    for key in ("down_filters", "up_filters"):
        kw[key] = tuple(kw[key])
    return config_for_variant(cell.config["variant"], **kw)


@torch.no_grad()
def load_state(state, weights: dict, seeds: dict) -> None:
    """The benchmark's weights into the program's modules (every parameter,
    by name, strict) and its seeds into the program's generators."""
    for net, module in (("generator", state.generator), ("discriminator", state.discriminator)):
        params = dict(module.named_parameters())
        if set(params) != set(weights[net]):
            raise RuntimeError(f"{net}: the program's parameters {sorted(params)} are not "
                               f"the benchmark's {sorted(weights[net])}")
        for name, p in params.items():
            p.copy_(weights[net][name])
    state.aug_generator.manual_seed(seeds["augment"])
    state.dropout_generator.manual_seed(seeds["dropout"])


def networks(state, config: dict):
    beta1 = config["settings"]["beta1"]

    def first_gradient(param_state):
        return param_state["m"] / (1.0 - beta1)

    return (("generator", state.generator, state.g_optimizer, first_gradient),
            ("discriminator", state.discriminator, state.d_optimizer, first_gradient))


def losses_of(metrics: dict) -> list:
    """[[generator total, discriminator total]] of each step of a chunk."""
    g = metrics["generator/total_loss"].float().cpu().tolist()
    d = metrics["discriminator/total_loss"].float().cpu().tolist()
    return [list(pair) for pair in zip(g, d)]


def plant_half_batch() -> None:
    """Each train step takes the first half of its batch; the loss means
    over those rows."""
    from palette_and_histo_gan_tpu_torch.train import steps

    for attr in ("rgba_train_step", "indexed_train_step"):
        original = getattr(steps, attr)

        def halved(config, st, source, target, group=None, _step=original):
            half = source.shape[0] // 2
            return _step(config, st, source[:half], target[:half], group)

        setattr(steps, attr, halved)
