"""The losses of the reference experiments, plain float32.

pix2pix (pix2pix_model.py of fegemo/palette-and-histo-gan): the
adversarial terms are keras BinaryCrossentropy(from_logits=True), a plain
mean; the generator adds lambda_l1 times the mean absolute error. The
indexed model's segmentation term is keras CategoricalCrossentropy on the
softmax of the logits against one-hot labels: the probability clipped to
[eps, 1 - eps] (eps 1e-7), -log of it, a mean over every pixel; a label
outside 0-255 has an all-zero one-hot row and adds 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

KERAS_EPSILON = 1e-7


def bce(logits, label: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


def l1(real, fake):
    return torch.mean(torch.abs(real - fake))


def segmentation(labels, logits):
    """labels (B, H, W) int, logits (B, C, H, W)."""
    classes = logits.shape[1]
    valid = (labels >= 0) & (labels < classes)
    logp = torch.log_softmax(logits.float(), dim=1)
    picked = -logp.gather(1, labels.clamp(0, classes - 1)[:, None].long())[:, 0]
    clipped = picked.clamp(-math.log1p(-KERAS_EPSILON), -math.log(KERAS_EPSILON))
    return torch.mean(torch.where(valid, clipped, torch.zeros_like(clipped)))
