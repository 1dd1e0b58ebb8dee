"""GAN losses with keras-parity reductions.

Mirrors palette_and_histo_gan_tpu/train/losses.py:19-23 and :149-180: keras
BinaryCrossentropy(from_logits=True) is a plain mean of the per-element
sigmoid cross-entropy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
