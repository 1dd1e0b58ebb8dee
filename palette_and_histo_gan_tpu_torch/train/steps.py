"""The train steps of the four variants, the chunked training loop and the
generate core.

Mirrors palette_and_histo_gan_tpu/train/steps.py: `rgba_train_step`
(:170-310) with its histogram dispatch (:234-276), `indexed_train_step`
(:318-394), the u32 row pack (:402-426), `make_train_step` (:454),
`make_train_chunk` (:467-515), `generate_core` (:536-570) and
`make_discriminate_fn` (:578-588). Where JAX
takes `value_and_grad` of two pure loss functions, a step runs the
generator once, backpropagates the generator loss into the generator's
parameters only, runs the discriminator on the detached fake,
backpropagates into the discriminator's parameters only, and then applies
both Adam updates, so both gradients see the parameters of before the
step. Metric names are the JAX package's `generator/*` and
`discriminator/*`.
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
from .losses import (
    bce_with_logits,
    discriminator_loss,
    generator_loss,
    onehot_l1_logits,
    sparse_categorical_crossentropy_logits,
)
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


def indexed_train_step(config: Config, state: TrainState, source_idx, target_idx) -> dict:
    """One optimization step on int32 (B, 64, 64, 1) palette-index maps, in
    place on `state`. Returns detached 0-dim metrics.

    G sees the source map as float32 on the raw index scale and returns
    256 logits a pixel; the fake map is their argmax. The adversarial term
    goes through that argmax, so it trains nothing: D is evaluated on the
    fake map without a graph and only lambda_segmentation times the sparse
    cross-entropy reaches G (lambda_l1 is 0; the L1 is logged). D's step
    is one pass over the stacked [real; fake] and [source; source] batch,
    as the JAX step runs it (:377-383)."""
    gen, disc = state.generator, state.discriminator
    source = source_idx.float()
    real = target_idx.float()
    labels = target_idx[..., 0]

    logits = gen(
        source, state.dropout_generator, deterministic=config.deterministic_dropout,
        logits=True,
    )
    fake = torch.argmax(logits, dim=-1, keepdim=True).float()
    with torch.no_grad():
        fake_pred = disc(fake, source)
    adversarial = bce_with_logits(torch.ones_like(fake_pred), fake_pred)
    l1 = onehot_l1_logits(labels, logits)
    seg = sparse_categorical_crossentropy_logits(labels, logits)
    total = adversarial + config.effective_lambda_l1 * l1 + config.lambda_segmentation * seg
    g_metrics = {
        "total_loss": total,
        "adversarial_loss": adversarial,
        "l1_loss": l1,
        "segmentation_loss": seg,
    }

    gen.zero_grad(set_to_none=True)
    disc.zero_grad(set_to_none=True)
    total.backward(inputs=list(gen.parameters()))
    del logits  # (B, 64, 64, 256): 2 GiB at b1024 bf16 that D's step does not need

    real_pred, fake_pred = disc(
        torch.cat([real, fake], dim=0), torch.cat([source, source], dim=0)
    ).chunk(2, dim=0)
    d_metrics = discriminator_loss(real_pred, fake_pred)
    d_metrics["total_loss"].backward(inputs=list(disc.parameters()))

    state.g_optimizer.step()
    state.d_optimizer.step()
    state.step += 1
    metrics = {f"generator/{k}": v.detach() for k, v in g_metrics.items()}
    metrics.update({f"discriminator/{k}": v.detach() for k, v in d_metrics.items()})
    return metrics


def step_function(config: Config) -> Callable:
    """The variant's step, (config, state, source, target) -> metrics."""
    return indexed_train_step if config.is_indexed else rgba_train_step


def make_train_step(config: Config) -> Callable:
    """(state, source, target) -> metrics, updating `state` in place."""
    step_fn = step_function(config)

    def train_step(state: TrainState, source, target) -> dict:
        return step_fn(config, state, source, target)

    return train_step


def make_train_chunk(config: Config, dataset_size: int, data_seed: int) -> Callable:
    """(state, (sources, targets), num_steps) -> metrics stacked over the
    steps, still on the device.

    Each step draws its batch from the epoch-permutation sampler
    (data.loader.batch_indices) at the state's global step and gathers it
    from the device-resident splits: uint8 RGBA, packed to one word a pixel
    when the step takes packed pixels, or the indexed variant's int32 maps
    as they are. The caller fetches the stacked metrics once per chunk."""
    packed = step_wants_packed(config)
    step_fn = step_function(config)

    def train_chunk(state: TrainState, dataset, num_steps: int) -> dict:
        sources, targets = dataset
        if packed:
            sources, targets = pack_rows(sources), pack_rows(targets)
        history = []
        for _ in range(num_steps):
            idx = batch_indices(
                data_seed, state.step, dataset_size, config.batch_size, sources.device
            )
            history.append(step_fn(config, state, sources[idx], targets[idx]))
        return {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return train_chunk


@torch.no_grad()
def generate(config: Config, generator, source: torch.Tensor,
             dropout_generator: torch.Generator) -> torch.Tensor:
    """The generator at inference, dropout active as the reference runs it:
    a normalized RGBA source -> the [-1, 1] fake; an int32 index map ->
    the int32 argmax map of the logits, taken in the compute dtype."""
    if config.is_indexed:
        logits = generator(source.float(), dropout_generator, logits=True)
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    return generator(source, dropout_generator)


@torch.no_grad()
def discriminate(config: Config, discriminator, target: torch.Tensor,
                 source: torch.Tensor) -> torch.Tensor:
    """The discriminator's patch probabilities, the sigmoid of its
    (B, 32, 32, 1) logits, for the patch-map debug figures."""
    return torch.sigmoid(discriminator(target, source))
