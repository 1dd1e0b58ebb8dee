"""HistoGAN's first training steps, plain float32 torch, worked out from the
benchmark's weights and seeds: the reference that decides `correct` for a
configuration of models/histogan.py.

A step, as stylegan2-ada-pytorch's `training_loop.py` and `loss.py` run
`--cfg=paper256` with lazy regularization, and HistoGAN's loss:
  * the batch: the epoch-permutation sampler (draws.py::batch_indices),
    uint8 images / 127.5 - 1; their RGB-uv histograms once, without
    gradient: clamp to [-1, 1], bilinear resize (align_corners False) to
    histogram_resize where the image is wider, histogram.py's histograms;
  * Gmain: softplus(-D(G(z))) + lambda_histogram x Hellinger(target, the
    fakes' histograms); Greg where step % g_reg_interval == 0, on the first
    batch / pl_batch_shrink images and targets: the path length
    |J^T y|, y = N(0, 1) / R, over the mapped w's and the histogram's w
    (mean of squares over the w's), pl_mean = pl_mean.lerp(mean length,
    pl_decay), penalty pl_weight (length - pl_mean)^2, its backward times
    the interval; Dmain: softplus(D(G(z))) and softplus(-D(x)), one
    backward each; Dreg where step % d_reg_interval == 0: R1, r1_gamma / 2
    |dD(x)/dx|^2, times the interval. A regularizer's term (without the
    interval) is added to its network's reported total loss;
  * each phase's gradient: non-finite entries to 0 or +-1e5, then Adam
    (torch's form: eps added to the corrected sqrt(v)) with lr c and betas
    ** c, c = interval / (interval + 1), one step count a parameter over
    both of its network's phases;
  * every G run maps z (updating w_avg = mean(w).lerp(w_avg, w_avg_beta))
    and z_mix, the ws from the cutoff layer on taken from z_mix;
  * the EMA of G: p_ema = p.lerp(p_ema, 0.5 ** (batch / (ema_kimg x
    1000))), w_avg copied.

The draws are a frozen copy of the port's rule (palette_and_histo_gan_tpu_
torch/train/histogan.py::phase_draws) on a generator seeded with the
run's "dropout" seed, on the device the program ran on: a phase draws one
normal tensor of batch x (2 z_dim + the noise inputs' pixels) (+ batch x 3
x R x R in the path-length phase), cut into z, z_mix, the noise inputs in
the layers' order and the path-length noise, then two uniforms u: mixing
where u0 < style_mixing, from layer 1 + floor(u1 (num_ws - 1)).

The readings: each step's [G total, D total]; each parameter's first
gradient as its optimizer got it after step 0, i.e. that of the network's
last phase there (Greg's and Dreg's, both running at step 0, times their
interval), which Adam's first moment holds at beta1 = 0; each parameter's
change over the steps.

Followed phases (`follow`): Adam's first steps are nearly sign steps, and
the histogram loss's gradient is ill-conditioned (pixels near the clamp,
1 / (x + 1e-6) in the log-chroma), so two float32 runs that round in
another order part within a phase and read gaps of 1e-3 to 3e-1 after it,
whatever the precision. A run that follows another's phase points
evaluates every phase at the parameters the other held when it ran that
phase, and takes its own Adam step from there: the losses, the first
gradients and the last steps' changes then compare one phase at a time.
The points are read from the other run after step 0 and after the last
step (`points`): each network's parameters then ("after") and before its
last Adam step ("before"); with no regularization phase after step 0 that
names every phase of up to three steps (`followed_phases`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import draws
from . import histogan_nets as nets
from .histogram import hellinger, histograms
from .precision import Precision


def settings(config: dict, traffic: dict) -> dict:
    return dict(config["settings"], batch_size=traffic["batch_size"])


def target_histograms(s, images, prec):
    x = images.clamp(-1.0, 1.0)
    side = min(s["resolution"], s["histogram_resize"])
    if x.shape[-1] > side:
        x = F.interpolate(x, size=(side, side), mode="bilinear", align_corners=False)
    return histograms(x.permute(0, 2, 3, 1), s["histogram_size"], s["histogram_sigma"], prec)


def phase_draws(s, gen, batch, path_length=False):
    r = s["resolution"]
    sizes = [batch * s["z_dim"]] * 2 + [batch * n * n for n in nets.noise_resolutions(s)]
    if path_length:
        sizes.append(batch * 3 * r * r)
    parts = torch.randn(sum(sizes), generator=gen, device=gen.device).split(sizes)
    u = torch.rand(2, generator=gen, device=gen.device)
    n_ws = nets.num_ws(s)
    cutoff = int(1.0 + torch.floor(u[1] * (n_ws - 1))) if float(u[0]) < s["style_mixing"] else n_ws
    noises = [q.view(batch, 1, n, n) for q, n in zip(parts[2:], nets.noise_resolutions(s))]
    return {"z": parts[0].view(batch, -1), "z_mix": parts[1].view(batch, -1), "cutoff": cutoff,
            "noises": noises,
            "pl_noise": parts[-1].view(batch, 3, r, r) / r if path_length else None}


class Phases:
    """The networks' parameters, moments, w_avg, pl_mean and the four
    phases."""

    def __init__(self, s, weights, prec):
        self.s, self.prec = s, prec
        self.p = {k: {n: w.detach().clone() for n, w in ws.items()} for k, ws in weights.items()}
        self.trained = {k: [n for n in ws if n not in nets.BUFFERS] for k, ws in self.p.items()}
        self.moments = {k: {n: [torch.zeros_like(self.p[k][n]), torch.zeros_like(self.p[k][n]), 0]
                            for n in names} for k, names in self.trained.items()}
        self.pl_mean = torch.zeros((), device=weights["generator"]["mapping.w_avg"].device)
        self.ema = {n: w.clone() for n, w in self.p["generator"].items()}
        self.last_grads = {}
        self.before = {}

    def points(self) -> dict:
        """{net: {"after": parameters, "before": those before its last Adam
        step}}, copies."""
        return {net: {"after": {n: self.p[net][n].detach().clone() for n in names},
                      "before": dict(self.before[net])}
                for net, names in self.trained.items()}

    @torch.no_grad()
    def _follow(self, point):
        """The followed run's parameters, where it names them for this phase."""
        for net, params in (point or {}).items():
            for n in self.trained[net]:
                self.p[net][n].copy_(params[n])

    def run_g(self, d, hist_flat):
        s, g = self.s, self.p["generator"]
        w = nets.mapping(s, g, d["z"])
        with torch.no_grad():
            g["mapping.w_avg"].copy_(w.detach().mean(dim=0).lerp(g["mapping.w_avg"],
                                                                 s["w_avg_beta"]))
        w_mix = nets.mapping(s, g, d["z_mix"])
        n_ws, c = nets.num_ws(s), d["cutoff"]
        ws = torch.cat([w[:, None].repeat(1, c, 1), w_mix[:, None].repeat(1, n_ws - c, 1)], dim=1)
        w_hist = nets.projection(s, g, hist_flat)
        return nets.synthesis(s, g, ws, w_hist, d["noises"]), ws, w_hist

    def _grads(self, net, loss):
        return torch.autograd.grad(loss, [self.p[net][n] for n in self.trained[net]])

    def _adam(self, net, grads, c):
        s = self.s
        lr = s["learning_rate"] * c
        b1, b2 = s["beta1"] ** c, s["beta2"] ** c
        self.last_grads[net] = {}
        self.before[net] = {n: self.p[net][n].detach().clone() for n in self.trained[net]}
        with torch.no_grad():
            for n, grad in zip(self.trained[net], grads):
                grad = torch.nan_to_num(grad, nan=0.0, posinf=1e5, neginf=-1e5)
                self.last_grads[net][n] = grad
                m, v, t = self.moments[net][n]
                t += 1
                self.moments[net][n][2] = t
                m.mul_(b1).add_(grad, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
                denom = v.sqrt() / math.sqrt(1.0 - b2**t) + s["adam_eps"]
                self.p[net][n].sub_(lr / (1.0 - b1**t) * m / denom)

    def _train(self, net, flag):
        for n in self.trained[net]:
            self.p[net][n].requires_grad_(flag)

    def step(self, reals, gen, step, follow=None):
        """One step; `follow`: {phase: {net: parameters}} of this step's
        followed phases."""
        s, prec = self.s, self.prec
        follow = follow or {}
        batch = reals.shape[0]
        with torch.no_grad():
            real_hist = target_histograms(s, reals, prec)
        cg = s["g_reg_interval"] / (s["g_reg_interval"] + 1)
        cd = s["d_reg_interval"] / (s["d_reg_interval"] + 1)
        d = self.p["discriminator"]
        # Gmain
        self._follow(follow.get("Gmain"))
        self._train("generator", True)
        img, _, _ = self.run_g(phase_draws(s, gen, batch), real_hist.flatten(1))
        adversarial = F.softplus(-nets.discriminator(s, d, img)).mean()
        h_loss = hellinger(real_hist, target_histograms(s, img, prec))
        g_total = adversarial + s["lambda_histogram"] * h_loss
        self._adam("generator", self._grads("generator", g_total), cg)
        g_total = float(g_total.detach())
        # Greg
        if step % s["g_reg_interval"] == 0:
            self._follow(follow.get("Greg"))
            half = batch // s["pl_batch_shrink"]
            dr = phase_draws(s, gen, half, path_length=True)
            img, ws, w_hist = self.run_g(dr, real_hist[:half].flatten(1))
            g_ws, g_hist = torch.autograd.grad((img * dr["pl_noise"]).sum(), [ws, w_hist],
                                               create_graph=True)
            lengths = torch.cat([g_ws, g_hist[:, None]], dim=1).square().sum(2).mean(1).sqrt()
            pl_mean = self.pl_mean.lerp(lengths.mean(), s["pl_decay"])
            self.pl_mean = pl_mean.detach()
            penalty = (lengths - pl_mean).square() * s["pl_weight"]
            loss = (img[:, 0, 0, 0] * 0 + penalty).mean() * s["g_reg_interval"]
            self._adam("generator", self._grads("generator", loss), cg)
            g_total += float(penalty.detach().mean())
        self._train("generator", False)
        # Dmain
        self._follow(follow.get("Dmain"))
        self._train("discriminator", True)
        with torch.no_grad():
            fake, _, _ = self.run_g(phase_draws(s, gen, batch), real_hist.flatten(1))
        loss_fake = F.softplus(nets.discriminator(s, d, fake)).mean()
        loss_real = F.softplus(-nets.discriminator(s, d, reals)).mean()
        g_fake = self._grads("discriminator", loss_fake)
        g_real = self._grads("discriminator", loss_real)
        self._adam("discriminator", [a + b for a, b in zip(g_fake, g_real)], cd)
        d_total = float(loss_fake.detach()) + float(loss_real.detach())
        # Dreg
        if step % s["d_reg_interval"] == 0:
            self._follow(follow.get("Dreg"))
            x = reals.detach().requires_grad_(True)
            logits = nets.discriminator(s, d, x)
            (grads,) = torch.autograd.grad(logits.sum(), [x], create_graph=True)
            penalty = grads.square().sum(dim=(1, 2, 3)) * (s["r1_gamma"] / 2)
            loss = (logits * 0 + penalty).mean() * s["d_reg_interval"]
            self._adam("discriminator", self._grads("discriminator", loss), cd)
            d_total += float(penalty.detach().mean())
        self._train("discriminator", False)
        # the EMA
        beta = 0.5 ** (batch / max(s["ema_kimg"] * 1000, 1e-8))
        with torch.no_grad():
            for n, w in self.p["generator"].items():
                self.ema[n] = w.lerp(self.ema[n], beta) if n not in nets.BUFFERS else w.clone()
        return [g_total, d_total]


def followed_phases(points: dict, steps: int, s: dict) -> dict:
    """{step: {phase: {net: parameters}}} from a run's points after step 0
    and after `steps` steps (points[1], points[steps]): step 0's Gmain and
    Dmain start from the drawn weights, as the followed run did; Greg and
    Dreg take the points before each network's last step; from step 1 on
    each network's one step a step is its main phase, so the points after
    step 0 and, one step back, after the last step name every other
    phase."""
    if not 1 <= steps <= 3 or min(s["g_reg_interval"], s["d_reg_interval"]) < steps:
        raise ValueError(f"{steps} steps cannot be followed from two points: a network "
                         "takes more than one unread step")
    first, last = points[1], points[steps]
    g0, d0 = first["generator"], first["discriminator"]
    phases = {0: {"Greg": {"generator": g0["before"]}, "Dmain": {"generator": g0["after"]},
                  "Dreg": {"discriminator": d0["before"]}}}
    if steps >= 2:
        g, d = last["generator"], last["discriminator"]
        # G after step steps - 2's Gmain: after step 0, or one step back from the last
        phases[1] = {"Gmain": {"generator": g0["after"]}}
        phases[steps - 1] = dict(phases.get(steps - 1, {}),
                                 Gmain={"generator": g["before"]},
                                 Dmain={"generator": g["after"], "discriminator": d["before"]})
        if steps == 3:
            phases[1]["Dmain"] = {"generator": g["before"], "discriminator": d0["after"]}
    return phases


def train(config: dict, traffic: dict, weights: dict, pairs: tuple, seeds: dict, steps: int,
          precision: str = "float32", keep_state: bool = False, follow: dict | None = None) -> dict:
    """The first `steps` steps from `weights` on the images pairs[0] (uint8
    (N, 3, R, R)); with `follow`, another run's points (see the module's
    docstring) whose phases this run follows. Also its own points after
    step 0 and after the last step ("points"), and with `keep_state` the
    parameters, the EMA and pl_mean after them ("state")."""
    if precision == "fp8":
        raise ValueError("HistoGAN runs in float32: its control is tf32")
    s = settings(config, traffic)
    images = pairs[0]
    device = images.device
    prec = Precision(precision)
    phases = followed_phases(follow, steps, s) if follow is not None else {}
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds["dropout"])
    out = {"losses": [], "points": {}}
    with prec.scope():
        ph = Phases(s, weights, prec)
        for step in range(steps):
            idx = draws.batch_indices(seeds["sampler"], step, images.shape[0], s["batch_size"],
                                      device)
            reals = images[idx].float() / 127.5 - 1.0
            out["losses"].append(ph.step(reals, gen, step, phases.get(step)))
            if step == 0:
                out["grad_norms"] = {net: {n: float(g.double().norm()) for n, g in gs.items()}
                                     for net, gs in ph.last_grads.items()}
            if step + 1 in (1, steps):
                out["points"][step + 1] = ph.points()
    out["change_norms"] = {net: {n: float((ph.p[net][n] - weights[net][n]).double().norm())
                                 for n in names} for net, names in ph.trained.items()}
    if keep_state:
        out["state"] = {"params": ph.p, "ema": ph.ema, "pl_mean": float(ph.pl_mean)}
    return out
