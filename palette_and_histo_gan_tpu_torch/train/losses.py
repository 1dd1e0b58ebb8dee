"""GAN losses with keras-parity reductions.

Mirrors palette_and_histo_gan_tpu/train/losses.py: keras
BinaryCrossentropy(from_logits=True) is a plain mean of the per-element
sigmoid cross-entropy (:19-23, :149-180), and the indexed variant's keras
CategoricalCrossentropy(from_logits=False) and one-hot L1 come in a
probabilities form and a log-space form on logits that never builds the
(B, H, W, 256) probabilities (:24-146).

Labels above 255 exist: the palette index sums the slots a pixel matches
(ops/palette.py), and a pixel equal to the hotpink filler sums past 255.
tf.one_hot gives such a label an all-zero row, so it contributes 0 to the
cross-entropy and sum(p) to the L1, and the means still run over all
B * H * W positions. (`F.cross_entropy(ignore_index=...)` would average over
the valid positions only, and it rejects labels of 256 and more.)

The indexed train step takes both logits forms at once through
`ops/indexed_loss.py::indexed_losses`: a CUDA kernel pair on a card, and on
the CPU these two functions as they are (its plain version).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERAS_EPSILON = 1e-7  # keras backend epsilon, used by its probabilities CCE
# the clip bounds of -log(p) in float32, as the JAX package computes them
NEG_LOG_MIN = float(-torch.log1p(torch.tensor(-KERAS_EPSILON, dtype=torch.float32)))
NEG_LOG_MAX = float(-torch.log(torch.tensor(KERAS_EPSILON, dtype=torch.float32)))


def bce_with_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy, keras BinaryCrossentropy(from_logits=True)."""
    return F.binary_cross_entropy_with_logits(logits, labels)


def generator_loss(fake_predicted, fake_image, real_image, lambda_l1: float) -> dict:
    """Baseline generator loss (reference pix2pix_model.py:44-49). The L1
    term subtracts and averages in float32 even for bfloat16 operands."""
    adversarial = bce_with_logits(torch.ones_like(fake_predicted), fake_predicted)
    l1 = torch.mean(torch.abs(real_image.float() - fake_image.float()))
    return {
        "total_loss": adversarial + lambda_l1 * l1,
        "adversarial_loss": adversarial,
        "l1_loss": l1,
    }


def discriminator_loss(real_predicted, fake_predicted) -> dict:
    """PatchGAN discriminator loss (reference pix2pix_model.py:51-56)."""
    real = bce_with_logits(torch.ones_like(real_predicted), real_predicted)
    fake = bce_with_logits(torch.zeros_like(fake_predicted), fake_predicted)
    return {"total_loss": fake + real, "real_loss": real, "fake_loss": fake}


def categorical_crossentropy_probs(y_true: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """keras CategoricalCrossentropy(from_logits=False): renormalize the
    probabilities, clip to [eps, 1 - eps], -sum(y_true * log p) over the
    classes, mean over the rest."""
    probs = probs / probs.sum(-1, keepdim=True)
    probs = probs.clamp(KERAS_EPSILON, 1.0 - KERAS_EPSILON)
    return torch.mean(-(y_true * torch.log(probs)).sum(-1))


def _valid_label(labels: torch.Tensor, classes: int) -> torch.Tensor:
    """True where tf.one_hot(label, classes) has a one: 0 <= label < C."""
    return (labels >= 0) & (labels < classes)


def _select_label(labels: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values[..., label], and 0 for a label out of range (exact: one
    gathered element, no sum)."""
    classes = values.shape[-1]
    picked = values.gather(-1, labels.long().clamp(0, classes - 1)[..., None])[..., 0]
    return torch.where(_valid_label(labels, classes), picked, torch.zeros_like(picked))


def sparse_categorical_crossentropy_probs(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """categorical_crossentropy_probs(one_hot(labels), probs) with the log
    taken on the selected entries only."""
    total = probs.sum(-1)
    p_t = (_select_label(labels, probs) / total).clamp(KERAS_EPSILON, 1.0 - KERAS_EPSILON)
    valid = _valid_label(labels, probs.shape[-1])
    return torch.mean(torch.where(valid, -torch.log(p_t), torch.zeros_like(p_t)))


def onehot_l1_probs(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """mean |one_hot(labels) - probs|: with p >= 0 the class sum is
    1 + sum(p) - 2 p_t, and sum(p) for an all-zero row."""
    c = probs.shape[-1]
    total = probs.sum(-1)
    p_t = _select_label(labels, probs)
    valid = _valid_label(labels, c)
    return torch.mean(torch.where(valid, 1.0 + total - 2.0 * p_t, total) / c)


def _logsumexp_and_target(labels: torch.Tensor, logits: torch.Tensor):
    """logsumexp over the classes and the label's logit, both float32 (the
    logits upcast as the JAX package upcasts them)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    return lse, _select_label(labels, logits).float()


def sparse_categorical_crossentropy_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """sparse_categorical_crossentropy_probs(labels, softmax(logits)) in
    log space: the renormalize is the identity and -log(clip(p_t)) is
    clip(lse - z_t, -log(1 - eps), -log(eps)); the clip cuts the gradient
    where it binds, as keras' clip_by_value does."""
    lse, z_t = _logsumexp_and_target(labels, logits)
    neg_logp = (lse - z_t).clamp(NEG_LOG_MIN, NEG_LOG_MAX)
    valid = _valid_label(labels, logits.shape[-1])
    return torch.mean(torch.where(valid, neg_logp, torch.zeros_like(neg_logp)))


def onehot_l1_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """onehot_l1_probs(labels, softmax(logits)): 2 (1 - p_t) / C, and 1 / C
    for an out-of-range label."""
    c = logits.shape[-1]
    lse, z_t = _logsumexp_and_target(labels, logits)
    p_t = torch.exp(z_t - lse)
    valid = _valid_label(labels, c)
    return torch.mean(torch.where(valid, 2.0 * (1.0 - p_t), torch.ones_like(p_t)) / c)
