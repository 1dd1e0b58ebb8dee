"""The reference's first train steps: what the program's window starts
with, worked out again in plain float32 PyTorch from the same inputs, the
same initial weights and the same seeds.

A step (pix2pix_model.py's train_step of the published repository):
the batch at the global step from the epoch sampler; for the augmented
variants the paired augmentation; the generator with its dropout masks;
the generator loss through the discriminator at its pre-step weights
(BCE + lambda_l1 L1, + lambda_histogram Hellinger for the histogram model,
the indexed model: BCE of the argmax map, which trains nothing, +
lambda_segmentation CCE); the discriminator loss on (target, source) and
(detached fake, source); then keras Adam on both networks:
  m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
  p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps),
the step scale in float32 as keras computes it.

`train` returns each step's generator and discriminator loss, each
parameter's gradient norm at the first step, and each parameter's change
over all the steps, by network.
"""

from __future__ import annotations

import torch

from . import augment, draws, histogram, losses, nets
from .precision import Precision


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _adam_scale(b1: float, b2: float, t: int) -> float:
    one, f32 = torch.tensor(1.0), torch.float32
    b1, b2 = torch.tensor(b1, dtype=f32), torch.tensor(b2, dtype=f32)
    return float(torch.sqrt(one - b2 ** t) / (one - b1 ** t))


def _rgba_losses(config, traffic, g, d, src_u8, tgt_u8, aug_gen, keeps, prec):
    s = config["settings"]
    if config["variant"] in ("baseline", "histogram"):
        batch = src_u8.shape[0]
        src, tgt = augment.augment_pair(
            src_u8, tgt_u8, *draws.augment_params(aug_gen, batch, s["augment_probability"]))
    else:
        src, tgt = src_u8.float() / 127.5 - 1.0, tgt_u8.float() / 127.5 - 1.0
    src, tgt = prec.act(src), prec.act(tgt)  # the images as the compute dtype holds them
    src_c, tgt_c = _nchw(src), _nchw(tgt)
    fake_c = torch.tanh(nets.generator(config, g, src_c, keeps, prec))
    g_total = losses.bce(nets.discriminator(config, d, fake_c, src_c, prec), 1.0)
    g_total = g_total + s["lambda_l1"] * losses.l1(tgt_c, fake_c)
    if config["variant"] == "histogram":
        size, sigma = s["histogram_size"], s["histogram_sigma"]
        real_h = histogram.histograms(tgt, size, sigma, prec)
        fake_h = histogram.histograms(fake_c.permute(0, 2, 3, 1), size, sigma, prec)
        g_total = g_total + s["lambda_histogram"] * histogram.hellinger(real_h, fake_h)
    fake_c = fake_c.detach()
    return g_total, (tgt_c, fake_c, src_c)


def _indexed_losses(config, traffic, g, d, src_idx, tgt_idx, aug_gen, keeps, prec):
    s = config["settings"]
    src_c = _nchw(src_idx.float())
    real_c = _nchw(tgt_idx.float())
    logits = nets.generator(config, g, src_c, keeps, prec)
    fake_c = torch.argmax(logits, dim=1, keepdim=True).float()
    with torch.no_grad():
        adversarial = losses.bce(nets.discriminator(config, d, fake_c, src_c, prec), 1.0)
    g_total = adversarial + s["lambda_segmentation"] * losses.segmentation(tgt_idx[..., 0], logits)
    return g_total, (real_c, fake_c, src_c)


def train(config: dict, traffic: dict, weights: dict, pairs: tuple, seeds: dict, steps: int,
          precision: str = "float32") -> dict:
    """`steps` steps from `weights` ({"generator": {name: tensor}, ...}) on
    the train `pairs` (sources, targets) with the run's sub-seeds."""
    prec = Precision(precision)
    s, net = config["settings"], config["network"]
    device = pairs[0].device
    batch, n = traffic["batch_size"], pairs[0].shape[0]
    params = {k: {name: w.detach().float().clone() for name, w in ws.items()}
              for k, ws in weights.items()}
    moments = {k: {name: (torch.zeros_like(p), torch.zeros_like(p)) for name, p in ps.items()}
               for k, ps in params.items()}
    aug_gen = _generator(seeds["augment"], device)
    drop_gen = _generator(seeds["dropout"], device)
    step_losses = (_indexed_losses if config["variant"] == "indexed" else _rgba_losses)
    out = {"losses": [], "grad_norms": None, "change_norms": None}
    with prec.scope():
        for step in range(steps):
            idx = draws.batch_indices(seeds["sampler"], step, n, batch, device)
            keeps = [draws.dropout_keep(drop_gen, shape, net["dropout_rate"])
                     for shape in nets.dropout_shapes(config, batch)]
            g = {k: p.requires_grad_(True) for k, p in params["generator"].items()}
            d = {k: p.requires_grad_(True) for k, p in params["discriminator"].items()}
            g_total, (real_c, fake_c, src_c) = step_losses(
                config, traffic, g, d, pairs[0][idx], pairs[1][idx], aug_gen, keeps, prec)
            grads = {"generator": dict(zip(g, torch.autograd.grad(g_total, list(g.values()))))}
            d_total = (losses.bce(nets.discriminator(config, d, real_c, src_c, prec), 1.0)
                       + losses.bce(nets.discriminator(config, d, fake_c, src_c, prec), 0.0))
            grads["discriminator"] = dict(zip(d, torch.autograd.grad(d_total, list(d.values()))))
            out["losses"].append([float(g_total.detach()), float(d_total.detach())])
            if step == 0:
                out["grad_norms"] = {k: {name: float(t.double().norm()) for name, t in gs.items()}
                                     for k, gs in grads.items()}
            scale = _adam_scale(s["beta1"], s["beta2"], step + 1)
            with torch.no_grad():
                for k, gs in grads.items():
                    for name, grad in gs.items():
                        p, (m, v) = params[k][name], moments[k][name]
                        m.mul_(s["beta1"]).add_(grad, alpha=1.0 - s["beta1"])
                        v.mul_(s["beta2"]).addcmul_(grad, grad, value=1.0 - s["beta2"])
                        p.requires_grad_(False)
                        p.sub_(s["learning_rate"] * scale * m / (v.sqrt() + s["adam_eps"]))
            del grads, g, d, g_total, d_total, real_c, fake_c, src_c
    out["change_norms"] = {
        k: {name: float((params[k][name] - w.float()).double().norm()) for name, w in ws.items()}
        for k, ws in weights.items()}
    return out
