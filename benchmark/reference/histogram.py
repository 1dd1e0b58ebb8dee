"""The RGB-uv histogram loss of HistoGAN (Afifi et al., arXiv:2011.11731),
plain float32.

An image in [-1, 1] is rescaled to [0, 1], alpha dropped. For each channel
c with projections (p1, p2) in (R: G, B), (G: R, B), (B: R, G):
  Iy = sqrt(R^2 + G^2 + B^2 + eps),
  u = log(c + eps) - log(p1 + eps),  v = log(c + eps) - log(p2 + eps),
  k(d) = 1 / (1 + d^2 / sigma^2)   (the inverse-quadratic kernel),
  H_c[i, j] = sum over pixels of Iy k(u - t_i) k(v - t_j),
the bin centres t evenly from -3 to 3; the three planes normalized together
to sum 1. The Hellinger loss of two batches is
||sqrt(H_fake) - sqrt(H_real)||_2 / sqrt(2) / B, one norm over the batch.

`histograms` runs in blocks of images, so that the (block, HW, bins)
kernel values fit beside the networks: the forward under no_grad, the
backward block by block, each recomputed with autograd.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-6
TRIPLES = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def _planes(images, size, sigma, prec):
    """(b, 64, 64, >=3) in [-1, 1] -> normalized (b, 3, size, size)."""
    x = images[..., :3].reshape(images.shape[0], -1, 3) * 0.5 + 0.5
    iy = prec.act(torch.sqrt(torch.sum(x * x, dim=-1) + EPS))
    logs = torch.log(x + EPS)
    t = torch.linspace(-3.0, 3.0, size, device=x.device)
    planes = []
    for c, p1, p2 in TRIPLES:
        u = prec.act(logs[..., c] - logs[..., p1])[..., None]
        v = prec.act(logs[..., c] - logs[..., p2])[..., None]
        ku = prec.act(1.0 / (1.0 + (u - t) ** 2 / sigma ** 2))
        kv = prec.act(1.0 / (1.0 + (v - t) ** 2 / sigma ** 2))
        planes.append(prec.bmm(prec.act(iy[..., None] * ku).transpose(1, 2), kv))
    h = torch.stack(planes, dim=1)
    return h / h.sum((1, 2, 3), keepdim=True)


class _Blocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, size, sigma, prec, block):
        ctx.save_for_backward(images)
        ctx.args = (size, sigma, prec, block)
        with torch.no_grad():
            return torch.cat([_planes(images[i:i + block], size, sigma, prec)
                              for i in range(0, images.shape[0], block)])

    @staticmethod
    def backward(ctx, g):
        (images,) = ctx.saved_tensors
        size, sigma, prec, block = ctx.args
        grads = []
        for i in range(0, images.shape[0], block):
            with torch.enable_grad():
                x = images[i:i + block].detach().requires_grad_(True)
                torch.autograd.backward(_planes(x, size, sigma, prec), g[i:i + block])
            grads.append(x.grad)
        return torch.cat(grads), None, None, None, None


def histograms(images, size: int, sigma: float, prec, block: int = 128):
    return _Blocked.apply(images, size, sigma, prec, block)


def hellinger(real_h, fake_h):
    squares = torch.sum((torch.sqrt(fake_h) - torch.sqrt(real_h)) ** 2)
    return torch.sqrt(squares) / math.sqrt(2.0) / real_h.shape[0]
