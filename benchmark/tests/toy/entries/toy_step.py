"""Entry "toy_step": the toy model's program (models/toy.py) in plain
torch, nn.Modules and torch.optim.Adam, one step after another on the
batches of rows (step x batch + i) mod n; the window as entries/chunk.py's.
"""

import types

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.entries import chunk


class Generator(nn.Module):
    def __init__(self, net):
        super().__init__()
        c = net["channels"]
        self.conv1 = nn.Conv2d(3, c, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(c, eps=net["batch_norm_eps"], momentum=net["batch_norm_momentum"])
        self.conv2 = nn.Conv2d(c, 3, 3, padding=1)

    def forward(self, x):
        return torch.tanh(self.conv2(F.relu(self.bn(self.conv1(x)))))


class Discriminator(nn.Module):
    def __init__(self, net):
        super().__init__()
        c = net["channels"]
        self.slope = net["leaky_relu_slope"]
        self.conv = nn.Conv2d(6, c, 4, stride=2, padding=1, bias=False)
        self.head = nn.Conv2d(c, 1, 3, padding=1)

    def forward(self, target, source):
        return self.head(F.leaky_relu(self.conv(torch.cat([target, source], dim=1)), self.slope))


def train_step(state, source, target):
    g, d, s = state.generator, state.discriminator, state.settings
    fake = g(source)
    fake_logits = d(fake, source)
    g_loss = (F.binary_cross_entropy_with_logits(fake_logits, torch.ones_like(fake_logits))
              + s["lambda_l1"] * F.l1_loss(fake, target))
    real_logits, fake_logits = d(target, source), d(fake.detach(), source)
    d_loss = (F.binary_cross_entropy_with_logits(real_logits, torch.ones_like(real_logits))
              + F.binary_cross_entropy_with_logits(fake_logits, torch.zeros_like(fake_logits)))
    state.g_optimizer.zero_grad(set_to_none=True)
    state.d_optimizer.zero_grad(set_to_none=True)
    g_loss.backward(inputs=list(g.parameters()))
    d_loss.backward(inputs=list(d.parameters()))
    state.g_optimizer.step()
    state.d_optimizer.step()
    return g_loss.detach(), d_loss.detach()


def setup(ctx):
    model = ctx.cell.model
    config = model.port_config(ctx.cell, ctx.seeds)
    net, s = config["network"], config["settings"]
    g, d = Generator(net).to(ctx.device), Discriminator(net).to(ctx.device)
    state = types.SimpleNamespace(
        generator=g, discriminator=d, settings=s, step=0,
        g_optimizer=torch.optim.Adam(g.parameters(), lr=s["g_learning_rate"],
                                     betas=tuple(s["g_betas"]), eps=s["adam_eps"]),
        d_optimizer=torch.optim.Adam(d.parameters(), lr=s["d_learning_rate"],
                                     betas=tuple(s["d_betas"]), eps=s["adam_eps"]))
    model.load_state(state, ctx.weights, ctx.seeds)
    source, target = ctx.data["train"]
    batch = config["batch_size"]

    def run_chunk(n):
        losses = []
        for _ in range(n):
            rows = (state.step * batch + torch.arange(batch, device=ctx.device)) % source.shape[0]
            losses.append(torch.stack(train_step(state, source[rows], target[rows])))
            state.step += 1
        stacked = torch.stack(losses)
        return {"g_loss": stacked[:, 0], "d_loss": stacked[:, 1]}

    ctx.state, ctx.run_chunk, ctx.dataset = state, run_chunk, ctx.data["train"]


warm, window, free = chunk.warm, chunk.window, chunk.free
