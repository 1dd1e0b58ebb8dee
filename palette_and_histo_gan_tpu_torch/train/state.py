"""Train state: both networks, both optimizers, the step and the generators.

Mirrors palette_and_histo_gan_tpu/train/state.py. JAX's immutable pytree
becomes one mutable object that the train step updates in place; the
PRNG key it carried becomes two explicit `torch.Generator`s on the device,
one for the augmentation draws and one for the dropout masks.
`TrainState.state_dict()` is the whole of it as one plain dict, what a
checkpoint holds (train/checkpoint.py); `load_state_dict` puts one back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import Config, compute_dtype
from ..models.convert import flatten_tree
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
        # the state exists from the start, so that a fresh optimizer and a
        # restored one hold the same keys
        self.reset()

    @torch.no_grad()
    def reset(self) -> None:
        """Zero moments and step counts, as at construction."""
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"step": 0, "m": torch.zeros_like(p), "v": torch.zeros_like(p)}

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


# seed offsets of the state's augmentation and dropout generators: past the
# evaluations' seed + 1, + 2 and + 3
TRAIN_SEED_OFFSETS = (4, 5)


@dataclasses.dataclass
class TrainState:
    step: int
    generator: nn.Module
    discriminator: nn.Module
    g_optimizer: KerasAdam
    d_optimizer: KerasAdam
    aug_generator: torch.Generator
    dropout_generator: torch.Generator

    def _parts(self):
        return (("generator", self.generator, self.g_optimizer),
                ("discriminator", self.discriminator, self.d_optimizer))

    def state_dict(self) -> dict:
        """The whole state as one plain dict of tensors, ints and dicts:
        the step, both modules' state_dicts, both optimizers' moments and
        step counts by parameter name, and both generators' states (their
        Philox offsets make dropout and the augmentation draws repeat).
        The tensors are the live ones, not copies."""
        out: dict = {"step": self.step}
        for name, module, optimizer in self._parts():
            out[name] = module.state_dict()
            params = module.named_parameters()
            states = [(k, optimizer.state[p]) for k, p in params]
            out[f"{name}_optimizer"] = {
                key: {k: st[key] for k, st in states} for key in ("step", "m", "v")
            }
        out["aug_generator"] = self.aug_generator.get_state()
        out["dropout_generator"] = self.dropout_generator.get_state()
        return out

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a `state_dict()` in place, every tensor onto this state's
        device and dtype. A missing, extra or mis-shaped key raises
        ValueError before anything is changed."""
        current, given = flatten_tree(self.state_dict()), flatten_tree(state_dict)
        missing, extra = sorted(current.keys() - given.keys()), sorted(given.keys() - current.keys())
        if missing or extra:
            raise ValueError(f"train state: missing keys {missing[:3]}, extra keys {extra[:3]}")
        for key, ref in current.items():
            value = given[key]
            if isinstance(ref, torch.Tensor):
                if not isinstance(value, torch.Tensor) or value.shape != ref.shape:
                    shape = tuple(value.shape) if isinstance(value, torch.Tensor) else type(value)
                    raise ValueError(f"train state: {key} is {shape}, expected {tuple(ref.shape)}")
            elif type(value) is not int:
                raise ValueError(f"train state: {key} is {value!r}, expected an int")
        with torch.no_grad():
            for name, module, optimizer in self._parts():
                module.load_state_dict(state_dict[name])
                saved = state_dict[f"{name}_optimizer"]
                for k, p in module.named_parameters():
                    st = optimizer.state[p]
                    st["step"] = saved["step"][k]
                    st["m"].copy_(saved["m"][k])
                    st["v"].copy_(saved["v"][k])
        self.aug_generator.set_state(state_dict["aug_generator"].cpu())
        self.dropout_generator.set_state(state_dict["dropout_generator"].cpu())
        self.step = state_dict["step"]


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
    seeded from seed + 4 and seed + 5 (TRAIN_SEED_OFFSETS). The evaluations
    seed their own generators with seed + 1, + 2 and + 3, as the JAX
    Trainer does (its L1 report takes seed + 2), so that no evaluation
    replays the masks or draws of training."""
    device = torch.device(device)
    g, d = build_models(config, device, seed)
    aug_offset, dropout_offset = TRAIN_SEED_OFFSETS
    aug = torch.Generator(device=device)
    aug.manual_seed(seed + aug_offset)
    drop = torch.Generator(device=device)
    drop.manual_seed(seed + dropout_offset)
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
