"""What the benchmark hands the program and reads back from it.

The program is palette_and_histo_gan_tpu_torch: its config
(`config_for_variant` with the configuration file's settings and the
traffic's batch and dtype), its train state with the benchmark's weights
loaded and its augmentation and dropout generators seeded with the
benchmark's seeds, and its chunk. What is read back for `correct`: the
losses of the first steps, each parameter's first gradient as the
optimizer got it (keras Adam's first moment after one step is
(1 - beta1) times it) and each parameter's change after the first steps.
"""

from __future__ import annotations

import torch


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


def _networks(state):
    return (("generator", state.generator, state.g_optimizer),
            ("discriminator", state.discriminator, state.d_optimizer))


@torch.no_grad()
def gradient_norms(state, beta1: float) -> dict:
    """Each parameter's first gradient norm, from Adam's state after one step."""
    return {net: {name: float((opt.state[p]["m"] / (1.0 - beta1)).double().norm())
                  for name, p in module.named_parameters()}
            for net, module, opt in _networks(state)}


@torch.no_grad()
def change_norms(state, weights: dict) -> dict:
    return {net: {name: float((p - weights[net][name]).double().norm())
                  for name, p in module.named_parameters()}
            for net, module, _ in _networks(state)}


def losses_of(metrics: dict) -> list:
    """[[generator total, discriminator total]] of each step of a chunk."""
    g = metrics["generator/total_loss"].float().cpu().tolist()
    d = metrics["discriminator/total_loss"].float().cpu().tolist()
    return [list(pair) for pair in zip(g, d)]


def first_readings(run_chunk, state, weights: dict, beta1: float, steps: int) -> dict:
    """Drive the program through its first `steps` steps through the
    window's own call (`run_chunk(n)`: n steps, the stacked metrics) and
    read what `correct` compares: one step, then the rest."""
    out = {"losses": losses_of(run_chunk(1))}
    out["grad_norms"] = gradient_norms(state, beta1)
    out["losses"] += losses_of(run_chunk(steps - 1))
    out["change_norms"] = change_norms(state, weights)
    return out
