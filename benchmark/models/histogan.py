"""HistoGAN (Afifi et al., arXiv:2011.11731) on the StyleGAN2 backbone at
stylegan2-ada-pytorch's `paper256` widths, as palette_and_histo_gan_tpu_
torch trains it (models/histogan.py, train/histogan.py): seeded uint8 RGB
images, G's four phases (Gmain, Greg with the path length, Dmain, Dreg
with R1) each with its own Adam step, the EMA.

It names the code that does each part (models/__init__.py lists the
parts): the parameters of reference/histogan_nets.py, the reference steps
of reference/histogan_step.py, the FLOP count of counts/histogan_flops.py.
It holds what the harness hands the program and reads back: the port's
HistoGANConfig (the configuration's settings, the traffic's batch and
dtype), its state with the benchmark's parameters and
buffers loaded (the EMA a copy of G) and its draws' generator seeded with
the run's "dropout" seed, and its losses.

`networks(state, config)`: after step 0 each network's Adam has stepped
twice there (main, then regularization phase: both run at step 0), and
its first moment, at beta1 = 0 (the configuration's), holds the last
phase's gradient: m = (1 - beta1) g. The reference gives the same
gradient (Greg's and Dreg's, times their interval); a program that ran
another beta1 reads it off by the ratio.

The reference follows the program's phases (reference/histogan_step.py's
docstring: two float32 runs part within a phase, whatever the precision).
Each time the harness reads the program through `networks` (after step 0
and after the first steps) this module keeps, on the host, each network's
parameters and those before its last Adam step, which that step's
optimizer state gives back with the configuration's constants: p + lr_c /
(1 - beta1_c^t) m / (sqrt(v) / sqrt(1 - beta2_c^t) + eps), lr_c = lr c,
beta_c = beta ** c, c = interval / (interval + 1). `reference_train` of
the same seeds then evaluates every phase at the program's points and
compares one phase at a time. Where no program was read (a control run
against the reference alone), the float32 reference's own points stand
in for the program's.
"""

from __future__ import annotations

import math

import torch

from ..counts import histogan_flops
from ..reference import histogan_nets as nets
from ..reference import histogan_step

RANGES = ("batch-gather", "hist-fwd", "mapping", "G-fwd", "D-fwd", "loss", "PL", "R1",
          "optimizer", "ema")

# the points the next reference run of the same seeds follows: whose they
# are ("program" or "reference") and {step read after: points}
_followed = {"seeds": None, "of": None, "points": {}}


def _seeds_key(seeds: dict) -> tuple:
    return tuple(sorted(seeds.items()))


def reference_train(config: dict, traffic: dict, weights: dict, pairs: tuple, seeds: dict,
                    steps: int, precision: str = "float32") -> dict:
    """reference/histogan_step.py::train following the program's phase
    points of these seeds where they were read, else the float32
    reference's own (kept here for a control of the same seeds)."""
    points = _followed["points"]
    follow = None
    if _followed["seeds"] == _seeds_key(seeds) and {1, steps} <= set(points):
        device = pairs[0].device
        follow = {k: {net: {which: {n: t.to(device) for n, t in params.items()}
                            for which, params in net_points.items()}
                      for net, net_points in points[k].items()}
                  for k in (1, steps)}
    out = histogan_step.train(config, traffic, weights, pairs, seeds, steps, precision,
                              follow=follow)
    own = out.pop("points")
    if follow is None and precision == "float32":
        _followed.update(seeds=_seeds_key(seeds), of="reference", points=own)
    return out


def make_splits(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"train": (images,)}: `train_pairs` uniform uint8 (N, 3, R, R) images
    drawn on the device from `seed` in one call."""
    side = config["settings"]["resolution"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    images = torch.randint(0, 256, (traffic["train_pairs"], 3, side, side), generator=gen,
                           device=device, dtype=torch.uint8)
    return {"train": (images,), "test": None}


def parameter_shapes(config: dict) -> dict:
    return nets.parameter_shapes(config["settings"])


def flops_per_image(config: dict) -> float:
    return histogan_flops.flops_per_image(config["settings"])


def port_config(cell, seeds: dict):
    from palette_and_histo_gan_tpu_torch.models.histogan import HistoGANConfig

    t = cell.traffic
    return HistoGANConfig(**cell.config["settings"], batch_size=t["batch_size"],
                          compute_dtype=t["compute_dtype"])


@torch.no_grad()
def load_state(state, weights: dict, seeds: dict) -> None:
    """The benchmark's parameters and buffers into G and D (by name,
    strict), G's into the EMA, the run's "dropout" seed into the draws'
    generator."""
    for net, module in (("generator", state.generator), ("discriminator", state.discriminator)):
        held = module.state_dict()
        if set(held) != set(weights[net]):
            raise RuntimeError(f"{net}: the program's parameters and buffers {sorted(held)} are "
                               f"not the benchmark's {sorted(weights[net])}")
        for name, t in held.items():
            t.copy_(weights[net][name])
    state.generator_ema.load_state_dict(state.generator.state_dict())
    state.draws.manual_seed(seeds["dropout"])
    _followed.update(seeds=_seeds_key(seeds), of="program", points={})


@torch.no_grad()
def program_points(module, optimizer, s: dict, interval: int) -> dict:
    """{"after": parameters, "before": those before the last Adam step}, on
    the host; the step undone with the configuration's constants."""
    c = interval / (interval + 1)
    lr, b1, b2 = s["learning_rate"] * c, s["beta1"] ** c, s["beta2"] ** c
    after, before = {}, {}
    for name, p in module.named_parameters():
        st = optimizer.state[p]
        t = float(st["step"])
        denom = st["exp_avg_sq"].sqrt() / math.sqrt(1.0 - b2**t) + s["adam_eps"]
        after[name] = p.detach().to("cpu", copy=True)
        before[name] = torch.addcdiv(p, st["exp_avg"], denom, value=lr / (1.0 - b1**t)).cpu()
    return {"after": after, "before": before}


def networks(state, config: dict):
    s = config["settings"]
    beta1 = s["beta1"]

    def first_gradient(param_state):
        return param_state["exp_avg"] / (1.0 - beta1)

    if _followed["of"] == "program":
        _followed["points"][state.step] = {
            "generator": program_points(state.generator, state.g_optimizer, s, s["g_reg_interval"]),
            "discriminator": program_points(state.discriminator, state.d_optimizer, s,
                                     s["d_reg_interval"])}
    return (("generator", state.generator, state.g_optimizer, first_gradient),
            ("discriminator", state.discriminator, state.d_optimizer, first_gradient))


def losses_of(metrics: dict) -> list:
    """[[generator total, discriminator total]] of each step of a chunk."""
    g = metrics["generator/total_loss"].float().cpu().tolist()
    d = metrics["discriminator/total_loss"].float().cpu().tolist()
    return [list(pair) for pair in zip(g, d)]


def plant_half_batch() -> None:
    """Each train step takes the first half of its batch."""
    from palette_and_histo_gan_tpu_torch.train import histogan

    original = histogan.train_step

    def halved(cfg, state, reals_u8, _step=original):
        return _step(cfg, state, reals_u8[:reals_u8.shape[0] // 2])

    histogan.train_step = halved
