"""The plain networks, float32, NCHW, as functions of a dict of parameters.

pix2pix (Isola et al., arXiv:1611.07004) as fegemo/palette-and-histo-gan
builds it in keras:
  * generator: a U-Net of six down blocks (conv k4 s2 SAME without bias;
    instance norm from the second block on; LeakyReLU 0.3) and six up
    blocks (transposed conv k4 s2 SAME without bias; instance norm;
    dropout 0.5 on the first three; ReLU), each up block's output
    concatenated with the mirrored down block's, the last with the raw
    input; a head conv k4 s1 SAME with bias (SAME pads a k4 window 1
    before and 2 after); tanh for RGBA, the logits of a 256-way softmax
    for palette indices;
  * discriminator: a PatchGAN of one down block without norm on
    concat([target, source]) and a 1-channel head conv k4 s1 SAME with
    bias: (B, 1, 32, 32) patch logits.
Instance norm: per sample and channel over H and W, biased variance,
eps 1e-3 (tensorflow_addons' default), then a learned scale and offset.
Weights use PyTorch's layouts: conv (out, in, kh, kw), transposed conv
(in, out, kh, kw); `parameter_shapes` names them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def parameter_shapes(config: dict) -> dict:
    """{"generator": [(name, shape, kind)], "discriminator": [...]}, kind
    one of "kernel", "scale", "offset", "bias"."""
    net, s = config["network"], config["settings"]
    down, up = list(s["down_filters"]), list(s["up_filters"])
    g = []
    cin = net["generator_in_channels"]
    for i, f in enumerate(down):
        g.append((f"down.{i}.weight", (f, cin, 4, 4), "kernel"))
        if i:
            g += [(f"down.{i}.norm.scale", (f,), "scale"), (f"down.{i}.norm.offset", (f,), "offset")]
        cin = f
    skips = list(reversed(down[:-1])) + [net["generator_in_channels"]]
    for i, f in enumerate(up):
        g.append((f"up.{i}.weight", (cin, f, 4, 4), "kernel"))
        g += [(f"up.{i}.norm.scale", (f,), "scale"), (f"up.{i}.norm.offset", (f,), "offset")]
        cin = f + skips[i]
    g += [("head.weight", (net["generator_out_channels"], cin, 4, 4), "kernel"),
          ("head.bias", (net["generator_out_channels"],), "bias")]
    d_in = 2 * net["discriminator_in_channels"]
    d = [("down.weight", (64, d_in, 4, 4), "kernel"), ("head.weight", (1, 64, 4, 4), "kernel"),
         ("head.bias", (1,), "bias")]
    return {"generator": g, "discriminator": d}


def dropout_shapes(config: dict, batch: int) -> list[tuple]:
    """The (B, C, H, W) of each dropout layer's mask, in forward order."""
    net, s = config["network"], config["settings"]
    side = 64 >> len(s["down_filters"])
    shapes = []
    for f in s["up_filters"][:net["dropout_blocks"]]:
        side *= 2
        shapes.append((batch, f, side, side))
    return shapes


def instance_norm(x, scale, offset, eps):
    mean = x.mean((2, 3), keepdim=True)
    var = x.var((2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.view(1, -1, 1, 1) + offset.view(1, -1, 1, 1)


def head(prec, p, x):
    return prec.conv2d(F.pad(x, (1, 2, 1, 2)), p["head.weight"], p["head.bias"])


def generator(config: dict, p: dict, x, keeps, prec):
    """(B, C, 64, 64) float32 -> the head's (B, out, 64, 64) output before
    its activation; `keeps` are the dropout layers' keep masks."""
    net = config["network"]
    slope, eps, rate = net["leaky_relu_slope"], net["instance_norm_eps"], net["dropout_rate"]
    depth = len(config["settings"]["down_filters"])
    inputs, skips = x, []
    for i in range(depth):
        x = prec.conv2d(x, p[f"down.{i}.weight"], stride=2, padding=1)
        if i:
            x = prec.act(instance_norm(x, p[f"down.{i}.norm.scale"], p[f"down.{i}.norm.offset"],
                                       eps))
        x = prec.act(F.leaky_relu(x, slope))
        skips.append(x)
    for i, skip in enumerate(list(reversed(skips[:-1])) + [inputs]):
        x = prec.conv_transpose2d(x, p[f"up.{i}.weight"])
        x = prec.act(instance_norm(x, p[f"up.{i}.norm.scale"], p[f"up.{i}.norm.offset"], eps))
        if i < len(keeps):
            x = prec.act(torch.where(keeps[i], x / (1.0 - rate), torch.zeros_like(x)))
        x = torch.cat([F.relu(x), skip], dim=1)
    return head(prec, p, x)


def discriminator(config: dict, p: dict, target, source, prec):
    """(B, 1, 32, 32) patch logits of a (target, source) pair."""
    x = prec.conv2d(torch.cat([target, source], dim=1), p["down.weight"], stride=2, padding=1)
    return head(prec, p, prec.act(F.leaky_relu(x, config["network"]["leaky_relu_slope"])))
