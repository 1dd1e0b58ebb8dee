"""HistoGAN's training: its state, its step and its chunk
(models/histogan.py has the networks and `HistoGANConfig`).

A step runs StyleGAN2's four phases as stylegan2-ada-pytorch's training
loop runs them with lazy regularization, each with its own optimizer step:
  * Gmain: G's non-saturating logistic loss, softplus(-D(G(z))), plus
    lambda_histogram times the Hellinger distance between the target
    histograms and the histograms of G's images;
  * Greg, every `g_reg_interval` steps (step 0 among them): the path-length
    penalty pl_weight (|J^T y| - pl_mean)^2 on the first batch / `pl_batch_
    shrink` images, J the Jacobian of the image in the styles, y noise of
    variance 1 / pixels, pl_mean its running mean (decay `pl_decay`), the
    loss times the interval;
  * Dmain: softplus(D(G(z))) and softplus(-D(x)), one backward each;
  * Dreg, every `d_reg_interval` steps: R1, r1_gamma / 2 |dD(x)/dx|^2,
    times the interval.
Then the generator's EMA: p_ema = p.lerp(p_ema, 0.5 ** (batch / (ema_kimg
x 1000))), its buffers copied. Each network has one Adam (torch's eps
convention: eps added to the corrected sqrt(v)) for its main and its
regularization phase, lr and betas corrected by c = interval /
(interval + 1) (lr c, beta ** c). A phase trains its network only (the
other's parameters do not require grad), turns a non-finite gradient
entry into 0 or +-1e5, and steps. Every G run maps z through the mapping
network (its w_avg updated) and z_mix for style mixing (from a cutoff
layer on, with probability `style_mixing`), and takes the histogram's w
from the target histograms.

The target histograms are the step's reals': computed once a step without
gradient, the conditioning of each phase's G and the Hellinger loss's
targets; the PL phase takes the first half of them. An image's histogram:
clamp to [-1, 1] (the histogram's [0, 1] after rescaling), bilinear resize
to histogram_resize where the image is wider (HistoGAN's 150x150: 22,500
pixels), then kernels K3b and K4b in a float32 chain on the card
(ops/histogram_kernel.py::FusedHistogram, which pads to their 64-pixel
tile), their plain versions on the CPU.

Every draw comes from the state's `draws` generator, phase by phase
(`phase_draws`): Gmain's, then Greg's where it runs, then Dmain's.

Spans (utils/tracing.py): "batch-gather", "hist-fwd" (the reals' and the
fakes' histograms), "mapping" (mapping and projection), "G-fwd", "D-fwd",
"loss", "G-bwd", "D-bwd", "optimizer", "PL" (the whole Greg phase before
its optimizer step), "R1" (the whole Dreg phase before its optimizer step),
"ema", inside each step's "step". `reg_phases` counts the PL and R1 phases
run in this process.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F

from ..data.loader import batch_indices
from ..models.histogan import Discriminator, Generator, HistoGANConfig, no_weight_gradients
from ..ops import histogram as hist_ops
from ..ops import histogram_kernel as hk
from ..utils import tracing

# the regularization phases run in this process
reg_phases = {"PL": 0, "R1": 0}


def target_histograms(images: torch.Tensor, cfg: HistoGANConfig) -> torch.Tensor:
    """(B, 3, R, R) images in [-1, 1] (G's unbounded) -> (B, 3, size, size)
    RGB-uv histograms normalized to sum 1 an image."""
    x = images.clamp(-1.0, 1.0)
    side = cfg.histogram_side
    if x.shape[-1] != side:
        x = F.interpolate(x, size=(side, side), mode="bilinear", align_corners=False)
    flat = (x * 0.5 + 0.5).permute(0, 2, 3, 1).reshape(x.shape[0], side * side, 3)
    h = hk.FusedHistogram.apply(flat, cfg.histogram_size, cfg.histogram_method,
                                cfg.histogram_sigma, torch.float32, ("K3b", "K4b"))
    return h / h.sum(dim=(1, 2, 3), keepdim=True)


@dataclasses.dataclass
class PhaseDraws:
    z: torch.Tensor
    z_mix: torch.Tensor
    cutoff: torch.Tensor  # 0-dim float: the first layer styled by z_mix
    noises: list
    pl_noise: torch.Tensor | None


def phase_draws(generator: torch.Generator, batch: int, cfg: HistoGANConfig,
                path_length: bool = False) -> PhaseDraws:
    """One phase's draws, two calls: one normal draw of batch x (2 z_dim +
    the noise inputs' pixels) (+ batch x 3 x R x R for the path-length
    noise), cut in that order (z, z_mix, each noise input (B, 1, r, r) in
    the layers' order, the path-length noise / R); then two uniforms u:
    style mixing where u0 < style_mixing, from layer 1 + floor(u1 x
    (num_ws - 1)) on (float32), else none (cutoff num_ws)."""
    r = cfg.resolution
    sizes = [batch * cfg.z_dim] * 2 + [batch * n * n for n in cfg.noise_resolutions]
    if path_length:
        sizes.append(batch * 3 * r * r)
    flat = torch.randn(sum(sizes), generator=generator, device=generator.device)
    parts = flat.split(sizes)
    u = torch.rand(2, generator=generator, device=generator.device)
    num_ws = cfg.num_ws
    cutoff = torch.where(u[0] < cfg.style_mixing, 1.0 + torch.floor(u[1] * (num_ws - 1)),
                         torch.full_like(u[1], float(num_ws)))
    noises = [p.view(batch, 1, n, n) for p, n in zip(parts[2:], cfg.noise_resolutions)]
    pl_noise = parts[-1].view(batch, 3, r, r) / r if path_length else None
    return PhaseDraws(parts[0].view(batch, -1), parts[1].view(batch, -1), cutoff, noises, pl_noise)


def make_optimizer(cfg: HistoGANConfig, module, interval: int) -> torch.optim.Adam:
    """Adam with lazy regularization's correction c = interval / (interval
    + 1): lr c, betas ** c."""
    c = interval / (interval + 1)
    return torch.optim.Adam(module.parameters(), lr=cfg.learning_rate * c,
                            betas=(cfg.beta1**c, cfg.beta2**c), eps=cfg.adam_eps)


@dataclasses.dataclass
class HistoGANState:
    step: int
    generator: Generator
    discriminator: Discriminator
    generator_ema: Generator
    g_optimizer: torch.optim.Adam
    d_optimizer: torch.optim.Adam
    draws: torch.Generator
    pl_mean: torch.Tensor


def create_histogan_state(cfg: HistoGANConfig, device, seed: int) -> HistoGANState:
    """Both networks drawn from `seed` as the source draws them (N(0, 1)
    weights, N(0, 1 / multiplier) where a layer has one), the EMA a copy
    of G, the optimizers, the draws' generator seeded seed + 1, pl_mean 0."""
    device = torch.device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen, disc = Generator(cfg), Discriminator(cfg)
    gen, disc = gen.to(device).requires_grad_(False), disc.to(device).requires_grad_(False)
    draws = torch.Generator(device=device)
    draws.manual_seed(seed + 1)
    return HistoGANState(
        step=0, generator=gen, discriminator=disc, generator_ema=copy.deepcopy(gen),
        g_optimizer=make_optimizer(cfg, gen, cfg.g_reg_interval),
        d_optimizer=make_optimizer(cfg, disc, cfg.d_reg_interval), draws=draws,
        pl_mean=torch.zeros((), device=device))


def _optimizer_step(module, optimizer) -> None:
    with tracing.span("optimizer"):
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        for g in grads:
            torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5, out=g)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)


def _run_g(gen, d: PhaseDraws, hist_flat):
    with tracing.span("mapping"):
        ws, w_hist = gen.styles(d.z, d.z_mix, d.cutoff, hist_flat)
    with tracing.span("G-fwd"):
        return gen.synthesis(ws, w_hist, d.noises), ws, w_hist


def _g_main(cfg, state, real_hist, d: PhaseDraws) -> dict:
    gen, disc = state.generator, state.discriminator
    gen.requires_grad_(True)
    img, _, _ = _run_g(gen, d, real_hist.flatten(1))
    with tracing.span("D-fwd"):
        logits = disc(img)
    with tracing.span("hist-fwd"):
        fake_hist = target_histograms(img, cfg)
    with tracing.span("loss"):
        adversarial = F.softplus(-logits).mean()
        h_loss = hist_ops.hellinger_loss(real_hist, fake_hist)
        total = adversarial + cfg.lambda_histogram * h_loss
    with tracing.span("G-bwd"):
        total.backward()
    gen.requires_grad_(False)
    _optimizer_step(gen, state.g_optimizer)
    return {"adversarial_loss": adversarial.detach(), "histogram_loss": h_loss.detach(),
            "total_loss": total.detach()}


def _g_reg(cfg, state, real_hist, d: PhaseDraws) -> torch.Tensor:
    """The path-length phase; returns pl_weight x the mean penalty."""
    gen = state.generator
    gen.requires_grad_(True)
    with tracing.span("PL"):
        img, ws, w_hist = _run_g(gen, d, real_hist[:d.z.shape[0]].flatten(1))
        with no_weight_gradients():
            g_ws, g_hist = torch.autograd.grad((img * d.pl_noise).sum(), [ws, w_hist],
                                               create_graph=True)
        lengths = torch.cat([g_ws, g_hist[:, None]], dim=1).square().sum(2).mean(1).sqrt()
        pl_mean = state.pl_mean.lerp(lengths.mean(), cfg.pl_decay)
        state.pl_mean.copy_(pl_mean.detach())
        penalty = (lengths - pl_mean).square() * cfg.pl_weight
        (img[:, 0, 0, 0] * 0 + penalty).mean().mul(cfg.g_reg_interval).backward()
    gen.requires_grad_(False)
    reg_phases["PL"] += 1
    _optimizer_step(gen, state.g_optimizer)
    return penalty.detach().mean()


def _d_main(cfg, state, reals, real_hist, d: PhaseDraws) -> dict:
    gen, disc = state.generator, state.discriminator
    disc.requires_grad_(True)
    with torch.no_grad():
        fake, _, _ = _run_g(gen, d, real_hist.flatten(1))
    with tracing.span("D-fwd"):
        fake_logits = disc(fake)
    with tracing.span("loss"):
        loss_fake = F.softplus(fake_logits).mean()
    with tracing.span("D-bwd"):
        loss_fake.backward()
    with tracing.span("D-fwd"):
        real_logits = disc(reals)
    with tracing.span("loss"):
        loss_real = F.softplus(-real_logits).mean()
    with tracing.span("D-bwd"):
        loss_real.backward()
    disc.requires_grad_(False)
    _optimizer_step(disc, state.d_optimizer)
    return {"fake_loss": loss_fake.detach(), "real_loss": loss_real.detach()}


def _d_reg(cfg, state, reals) -> torch.Tensor:
    """The R1 phase; returns r1_gamma / 2 x the mean penalty."""
    disc = state.discriminator
    disc.requires_grad_(True)
    with tracing.span("R1"):
        x = reals.detach().requires_grad_(True)
        logits = disc(x)
        with no_weight_gradients():
            (grads,) = torch.autograd.grad(logits.sum(), [x], create_graph=True)
        penalty = grads.square().sum(dim=(1, 2, 3)) * (cfg.r1_gamma / 2)
        (logits * 0 + penalty).mean().mul(cfg.d_reg_interval).backward()
    disc.requires_grad_(False)
    reg_phases["R1"] += 1
    _optimizer_step(disc, state.d_optimizer)
    return penalty.detach().mean()


@torch.no_grad()
def update_ema(cfg: HistoGANConfig, state: HistoGANState, batch: int) -> None:
    """p_ema = p.lerp(p_ema, beta), beta = 0.5 ** (batch / (ema_kimg x
    1000)); the buffers copied."""
    with tracing.span("ema"):
        beta = 0.5 ** (batch / max(cfg.ema_kimg * 1000, 1e-8))
        ema = list(state.generator_ema.parameters())
        params = list(state.generator.parameters())
        torch._foreach_copy_(ema, torch._foreach_lerp(params, ema, beta))
        for b_ema, b in zip(state.generator_ema.buffers(), state.generator.buffers()):
            b_ema.copy_(b)


def train_step(cfg: HistoGANConfig, state: HistoGANState, reals_u8: torch.Tensor) -> dict:
    """One step on a uint8 (B, 3, R, R) batch, in place on `state`. Returns
    detached 0-dim metrics."""
    with tracing.span("batch-gather"):
        reals = reals_u8.float() / 127.5 - 1.0
    batch = reals.shape[0]
    with torch.no_grad(), tracing.span("hist-fwd"):
        real_hist = target_histograms(reals, cfg)
    zero = torch.zeros((), device=reals.device)
    g = _g_main(cfg, state, real_hist, phase_draws(state.draws, batch, cfg))
    g["pl_penalty"] = zero
    if state.step % cfg.g_reg_interval == 0:
        half = batch // cfg.pl_batch_shrink
        g["pl_penalty"] = _g_reg(cfg, state, real_hist,
                                 phase_draws(state.draws, half, cfg, path_length=True))
        g["total_loss"] = g["total_loss"] + g["pl_penalty"]
    d = _d_main(cfg, state, reals, real_hist, phase_draws(state.draws, batch, cfg))
    d["r1_penalty"] = zero
    d["total_loss"] = d["fake_loss"] + d["real_loss"]
    if state.step % cfg.d_reg_interval == 0:
        d["r1_penalty"] = _d_reg(cfg, state, reals)
        d["total_loss"] = d["total_loss"] + d["r1_penalty"]
    update_ema(cfg, state, batch)
    state.step += 1
    metrics = {f"generator/{k}": v for k, v in g.items()}
    metrics.update({f"discriminator/{k}": v for k, v in d.items()})
    metrics["generator/pl_mean"] = state.pl_mean.clone()
    return metrics


def make_histogan_chunk(cfg: HistoGANConfig, dataset_size: int, data_seed: int):
    """(state, reals, num_steps) -> metrics stacked over the steps, still on
    the device: each step's batch drawn by the epoch-permutation sampler
    (data.loader.batch_indices) at the state's step from `reals`, the
    device-resident uint8 (N, 3, R, R) images; the caller fetches the
    metrics once a chunk."""

    def chunk(state: HistoGANState, reals: torch.Tensor, num_steps: int) -> dict:
        history = []
        for _ in range(num_steps):
            with tracing.span("step", ranged=False):
                with tracing.span("batch-gather"):
                    idx = batch_indices(data_seed, state.step, dataset_size, cfg.batch_size,
                                        reals.device)
                    batch = reals[idx]
                history.append(train_step(cfg, state, batch))
        names = list(history[0])
        return {k: torch.stack([m[k] for m in history]) for k in names}

    return chunk

