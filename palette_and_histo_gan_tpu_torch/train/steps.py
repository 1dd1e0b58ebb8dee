"""The RGBA train step and the chunked training loop.

Mirrors palette_and_histo_gan_tpu/train/steps.py: `rgba_train_step`
(:170-310) with its histogram dispatch (:234-276), the u32 row pack
(:402-426), `make_train_step` (:454) and
`make_train_chunk` (:467-515). Where JAX takes `value_and_grad` of two
pure loss functions, this step runs the generator once, backpropagates the
generator loss into the generator's parameters only, runs the
discriminator on the detached fake in two separate passes, backpropagates
into the discriminator's parameters only, and then applies both Adam
updates, so both gradients see the parameters of before the step.
Metric names are the JAX package's `generator/*` and `discriminator/*`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..config import Config, compute_dtype
from ..data.loader import batch_indices
from ..ops import augment as augment_ops
from ..ops import histogram as hist_ops
from ..ops.histogram_pallas import calculate_rgbuv_histogram_pallas
from ..ops.histogram_pallas2 import calculate_rgbuv_histogram_pallas2
from ..ops.image import normalize
from .losses import discriminator_loss, generator_loss
from .state import TrainState


def pack_rows(arr: torch.Tensor) -> torch.Tensor:
    """uint8 (N, 64, 64, 4) -> int32 (N, 4096), each element the bit
    pattern of one little-endian RGBA pixel (a view, no copy). The row
    gather then moves one 4-byte word a pixel, and the augmentation kernel
    unpacks the channels in registers."""
    n = arr.shape[0]
    return arr.contiguous().view(n, -1).view(torch.int32)


def unpack_rows(arr: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_rows on a gathered batch: (B, 64, 64, 4) uint8."""
    return arr.contiguous().view(torch.uint8).reshape(arr.shape[0], 64, 64, 4)


def step_wants_packed(config: Config) -> bool:
    """True when the step consumes packed pixels: the augmentation (kernel
    on the card, plain version on the CPU) unpacks them itself."""
    return config.uses_augmentation


def _prepare_batch(config: Config, state: TrainState, source, target):
    """Raw [0, 255] batch -> normalized (augmented) [-1, 1] pair."""
    if config.uses_augmentation:
        # normalize folded into the augmentation's write; in bfloat16 mode
        # it writes bfloat16, as every consumer casts to it anyway
        return augment_ops.augment_batch(
            source, target, state.aug_generator, config.augment_probability,
            normalize_out=True, out_dtype=compute_dtype(config),
        )
    if source.dtype == torch.int32:
        source, target = unpack_rows(source), unpack_rows(target)
    return normalize(source.float()), normalize(target.float())


def histogram_fn(config: Config) -> Callable:
    """The histogram of `config.histogram_impl`, called as
    fn(batch, size=, method=, sigma=, dtype=), as the JAX step selects it
    (palette_and_histo_gan_tpu/train/steps.py:234-276): "pallas" drops
    `dtype` (its chain is float32), and `histogram_bwd` counts only under
    "xla"."""
    if config.histogram_impl == "pallas":

        def hist_fn(batch, dtype, **kw):
            return calculate_rgbuv_histogram_pallas(batch, **kw)

        return hist_fn
    if config.histogram_impl == "pallas2":
        return calculate_rgbuv_histogram_pallas2
    return partial(hist_ops.calculate_rgbuv_histogram, bwd=config.histogram_bwd)


def rgba_train_step(config: Config, state: TrainState, source, target) -> dict:
    """One optimization step on a raw [0, 255] RGBA batch (uint8, float32
    or packed int32), in place on `state`. Returns detached 0-dim metrics."""
    source, target = _prepare_batch(config, state, source, target)
    gen, disc = state.generator, state.discriminator
    dtype = compute_dtype(config)

    fake = gen(
        source, state.dropout_generator, deterministic=config.deterministic_dropout
    )
    g_metrics = generator_loss(disc(fake, source), fake, target, config.effective_lambda_l1)
    if config.model == "histogram":
        # two separate histogram calls, real and fake, as the JAX step runs them
        kw = dict(
            size=config.histogram_size, method=config.histogram_method,
            sigma=config.histogram_sigma, dtype=dtype,
        )
        hist_fn = histogram_fn(config)
        real_hist = hist_fn(target, **kw)
        fake_hist = hist_fn(fake, **kw)
        h_loss = hist_ops.hellinger_loss(real_hist, fake_hist)
        g_metrics["histogram_loss"] = h_loss
        g_metrics["total_loss"] = g_metrics["total_loss"] + config.lambda_histogram * h_loss

    gen.zero_grad(set_to_none=True)
    disc.zero_grad(set_to_none=True)
    g_metrics["total_loss"].backward(inputs=list(gen.parameters()))

    fake = fake.detach()
    # two separate D passes, as the reference runs them (pix2pix_model.py:69-70)
    d_metrics = discriminator_loss(disc(target, source), disc(fake, source))
    d_metrics["total_loss"].backward(inputs=list(disc.parameters()))

    state.g_optimizer.step()
    state.d_optimizer.step()
    state.step += 1
    metrics = {f"generator/{k}": v.detach() for k, v in g_metrics.items()}
    metrics.update({f"discriminator/{k}": v.detach() for k, v in d_metrics.items()})
    return metrics


def make_train_step(config: Config) -> Callable:
    """(state, source, target) -> metrics, updating `state` in place."""

    def train_step(state: TrainState, source, target) -> dict:
        return rgba_train_step(config, state, source, target)

    return train_step


def make_train_chunk(config: Config, dataset_size: int, data_seed: int) -> Callable:
    """(state, (sources, targets), num_steps) -> metrics stacked over the
    steps, still on the device.

    Each step draws its batch from the epoch-permutation sampler
    (data.loader.batch_indices) at the state's global step and gathers it
    from the device-resident uint8 splits, packed to one word a pixel when
    the step takes packed pixels. The caller fetches the stacked metrics
    once per chunk."""
    packed = step_wants_packed(config)

    def train_chunk(state: TrainState, dataset, num_steps: int) -> dict:
        sources, targets = dataset
        if packed:
            sources, targets = pack_rows(sources), pack_rows(targets)
        history = []
        for _ in range(num_steps):
            idx = batch_indices(
                data_seed, state.step, dataset_size, config.batch_size, sources.device
            )
            history.append(rgba_train_step(config, state, sources[idx], targets[idx]))
        return {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return train_chunk
