"""Train state: both networks, both optimizers, the step and the generators.

Mirrors palette_and_histo_gan_tpu/train/state.py. JAX's immutable pytree
becomes one mutable object that the train step updates in place; the
PRNG key it carried becomes two explicit `torch.Generator`s on the device,
one for the augmentation draws and one for the dropout masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import Config, compute_dtype
from ..models.networks import build_discriminator, build_generator, init_parameters


def _step_scale(b1: float, b2: float, t: int) -> float:
    """sqrt(1 - b2^t) / (1 - b1^t) in float32, as the JAX optimizer
    computes it (in float64, 1 - 0.999 alone differs by 5e-5 relative)."""
    one, t32 = np.float32(1.0), np.float32(t)
    return float(np.sqrt(one - np.float32(b2) ** t32) / (one - np.float32(b1) ** t32))


class KerasAdam(torch.optim.Optimizer):
    """Adam with the keras epsilon convention (state.py:46-98).

    keras folds the bias corrections into the step size and adds eps to the
    UNCORRECTED sqrt(v):

        p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)

    torch.optim.Adam adds eps to the corrected sqrt(v_hat), an effective eps
    ~32x smaller at t=1 for b2=0.999, which moves near-zero-gradient
    parameters by tens of percent more. The reference trains with keras Adam.
    """

    def __init__(self, params, lr=2e-4, betas=(0.5, 0.999), eps=1e-7):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KerasAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                m, v, g = state["m"], state["v"], p.grad
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                state["step"] += 1
                update = (_step_scale(b1, b2, state["step"]) * m) / (
                    v.sqrt() + group["eps"]
                )
                p.add_(update, alpha=-group["lr"])


def make_optimizer(config: Config, module: nn.Module) -> KerasAdam:
    """Adam(2e-4, beta1=0.5), keras eps 1e-7 (pix2pix_model.py:28-29)."""
    return KerasAdam(
        module.parameters(),
        lr=config.learning_rate,
        betas=(config.beta1, config.beta2),
        eps=config.adam_eps,
    )


@dataclasses.dataclass
class TrainState:
    step: int
    generator: nn.Module
    discriminator: nn.Module
    g_optimizer: KerasAdam
    d_optimizer: KerasAdam
    aug_generator: torch.Generator
    dropout_generator: torch.Generator


def build_models(config: Config, device, seed: int) -> tuple[nn.Module, nn.Module]:
    """Generator and discriminator on `device`, initialized from `seed`."""
    dtype = compute_dtype(config)
    init = torch.Generator(device=device)
    init.manual_seed(seed)
    g = build_generator(config, dtype).to(device)
    d = build_discriminator(config, dtype).to(device)
    init_parameters(g, init)
    init_parameters(d, init)
    return g, d


def create_train_state(config: Config, device, seed: int) -> TrainState:
    """Networks initialized from `seed`; augmentation and dropout generators
    seeded from seed + 1 and seed + 2."""
    device = torch.device(device)
    g, d = build_models(config, device, seed)
    aug = torch.Generator(device=device)
    aug.manual_seed(seed + 1)
    drop = torch.Generator(device=device)
    drop.manual_seed(seed + 2)
    return TrainState(
        step=0,
        generator=g,
        discriminator=d,
        g_optimizer=make_optimizer(config, g),
        d_optimizer=make_optimizer(config, d),
        aug_generator=aug,
        dropout_generator=drop,
    )


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
