"""HistoGAN's networks in plain float32 torch, functional, on a dict of
parameters: StyleGAN2's mapping, synthesis and residual discriminator as
stylegan2-ada-pytorch's `networks.py` writes them (its reference
`upfirdn2d`; the modulated convolution as it trains), and HistoGAN's
histogram projection.

Departures from the sources (the configuration file lists them under
"assumed"): float32 everywhere, no conv_clamp, no ADA (`--fp32=True
--aug=noaug`); the histogram projection's eight layers are equalized
fully-connected layers (learning-rate multiplier 1) with StyleGAN2's leaky
ReLU (0.2, times sqrt(2)), their input the three 64x64 planes flattened
plane by plane; the projection's w styles every layer of the last
`histogram_blocks` blocks, the mapped w's the rest (`num_ws`); the noise
inputs' constant buffers, unused in training, are left out.

Widths come from the configuration's "settings" (models/histogan.py
reads them), as the port's HistoGANConfig names them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def block_resolutions(s: dict) -> list:
    return [2**i for i in range(2, int(math.log2(s["resolution"])) + 1)]


def channels(s: dict, res: int) -> int:
    return min(s["channel_base"] // res, s["channel_max"])


def mapped_blocks(s: dict) -> int:
    return len(block_resolutions(s)) - s["histogram_blocks"]


def num_ws(s: dict) -> int:
    return 2 * mapped_blocks(s)


def noise_resolutions(s: dict) -> list:
    return [r for res in block_resolutions(s) for r in ([res] if res == 4 else [res, res])]


def _fc(name, fin, fout, std=1.0, bias=0.0):
    return [(f"{name}.weight", (fout, fin), ("normal", std)), (f"{name}.bias", (fout,), bias)]


def _layer(name, cin, cout, w_dim, k=3, noise=True):
    items = [(f"{name}.weight", (cout, cin, k, k), ("normal", 1.0)),
             (f"{name}.bias", (cout,), 0.0)]
    if noise:
        items.append((f"{name}.noise_strength", (), 0.0))
    return items + _fc(f"{name}.affine", w_dim, cin, bias=1.0)


def parameter_shapes(s: dict) -> dict:
    """{network: [(name, shape, init)]}: every parameter, and G's w_avg
    buffer, with the sources' initializers: N(0, 1) weights (N(0, 100) in
    the mapping, whose learning-rate multiplier is 0.01), biases 0 but the
    affine layers' 1, noise strengths 0."""
    w = s["w_dim"]
    g = []
    dims = [s["z_dim"]] + [w] * s["mapping_layers"]
    for i in range(s["mapping_layers"]):
        g += _fc(f"mapping.fc{i}", dims[i], dims[i + 1], std=1.0 / s["mapping_lr_multiplier"])
    pdims = [3 * s["histogram_size"] ** 2] + list(s["projection_widths"][:-1]) + [w]
    for i in range(len(s["projection_widths"])):
        g += _fc(f"projection.fc{i}", pdims[i], pdims[i + 1])
    for res in block_resolutions(s):
        c = channels(s, res)
        b = f"synthesis.b{res}"
        if res == 4:
            g.append((f"{b}.const", (c, 4, 4), ("normal", 1.0)))
        else:
            g += _layer(f"{b}.conv0", channels(s, res // 2), c, w)
        g += _layer(f"{b}.conv1", c, c, w)
        g += _layer(f"{b}.torgb", c, 3, w, k=1, noise=False)
    g.append(("mapping.w_avg", (w,), 0.0))
    d = []
    for res in block_resolutions(s)[:0:-1]:
        c, out = channels(s, res), channels(s, res // 2)
        b = f"b{res}"
        if res == s["resolution"]:
            d += [(f"{b}.fromrgb.weight", (c, 3, 1, 1), ("normal", 1.0)),
                  (f"{b}.fromrgb.bias", (c,), 0.0)]
        d += [(f"{b}.conv0.weight", (c, c, 3, 3), ("normal", 1.0)), (f"{b}.conv0.bias", (c,), 0.0),
              (f"{b}.conv1.weight", (out, c, 3, 3), ("normal", 1.0)),
              (f"{b}.conv1.bias", (out,), 0.0),
              (f"{b}.skip.weight", (out, c, 1, 1), ("normal", 1.0))]
    c4 = channels(s, 4)
    d += [("b4.conv.weight", (c4, c4 + 1, 3, 3), ("normal", 1.0)), ("b4.conv.bias", (c4,), 0.0)]
    d += _fc("b4.fc", c4 * 16, c4) + _fc("b4.out", c4, 1)
    return {"generator": g, "discriminator": d}


BUFFERS = ("mapping.w_avg",)


# ------------------------------------------------------------------ pieces


def fir_filter(device):
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    f = f[:, None] * f[None, :]
    return f / f.sum()


def upfirdn2d(x, f, up=1, down=1, pad=(0, 0, 0, 0), gain=1.0):
    """stylegan2-ada-pytorch's `_upfirdn2d_ref`: zeros inserted (up), zero
    padding (x0, x1, y0, y1), the flipped filter times gain, every
    down-th pixel."""
    n, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, list(pad))
    k = (f * gain).flip([0, 1])[None, None].repeat(c, 1, 1, 1)
    x = F.conv2d(x, k, groups=c)
    return x[:, :, ::down, ::down]


def lrelu(x, gain=1.0):
    return F.leaky_relu(x, 0.2) * (SQRT2 * gain)


def fc(p, name, x, act=True, lr_multiplier=1.0):
    w = p[f"{name}.weight"]
    y = F.linear(x, w * (lr_multiplier / math.sqrt(w.shape[1])), p[f"{name}.bias"] * lr_multiplier)
    return lrelu(y) if act else y


def modulated_conv(x, weight, styles, f, demodulate=True, up=False):
    """stylegan2-ada-pytorch's `modulated_conv2d` as it trains
    (fused_modconv off): the input scaled by the styles, one convolution
    with the shared weight (upsampling: `conv2d_resample`'s transposed
    convolution at stride 2, then the FIR times 4), the output scaled by
    the demodulation coefficients rsqrt(sum over (in, kh, kw) of
    (weight x style)^2 + 1e-8), taken from the (B, out, in, k, k) product."""
    x = x * styles[:, :, None, None]
    if up:
        x = F.conv_transpose2d(x, weight.transpose(0, 1), stride=2)
        x = upfirdn2d(x, f, pad=(1, 1, 1, 1), gain=4.0)
    else:
        x = F.conv2d(x, weight, padding=weight.shape[-1] // 2)
    if not demodulate:
        return x
    w = weight[None] * styles[:, None, :, None, None]
    return x * (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()[:, :, None, None]


def synthesis_layer(p, name, x, w, noise, f, up=False):
    styles = fc(p, f"{name}.affine", w, act=False)
    x = modulated_conv(x, p[f"{name}.weight"], styles, f, up=up)
    x = x + noise * p[f"{name}.noise_strength"]
    return lrelu(x + p[f"{name}.bias"].view(1, -1, 1, 1))


def torgb(p, name, x, w, f):
    weight = p[f"{name}.weight"]
    styles = fc(p, f"{name}.affine", w, act=False) / math.sqrt(weight.shape[1])
    x = modulated_conv(x, weight, styles, f, demodulate=False)
    return x + p[f"{name}.bias"].view(1, -1, 1, 1)


# --------------------------------------------------------------- networks


def mapping(s, p, z):
    x = z * (z.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()
    for i in range(s["mapping_layers"]):
        x = fc(p, f"mapping.fc{i}", x, lr_multiplier=s["mapping_lr_multiplier"])
    return x


def projection(s, p, hist_flat):
    x = hist_flat
    for i in range(len(s["projection_widths"])):
        x = fc(p, f"projection.fc{i}", x)
    return x


def synthesis(s, p, ws, w_hist, noises):
    """ws (B, num_ws, w_dim): block 4 takes w 0 (conv) and 1 (toRGB), a
    mapped block i > 0 takes 2i - 1, 2i (convs), 2i + 1 (toRGB); the
    histogram's blocks take w_hist for every layer."""
    f = fir_filter(ws.device)
    x = img = None
    at = 0
    for i, res in enumerate(block_resolutions(s)):
        b = f"synthesis.b{res}"
        n = 1 if res == 4 else 2
        if i < mapped_blocks(s):
            first = 0 if res == 4 else 2 * i - 1
            bw = [ws[:, first + j] for j in range(n + 1)]
        else:
            bw = [w_hist] * (n + 1)
        if res == 4:
            x = p[f"{b}.const"].unsqueeze(0).repeat(ws.shape[0], 1, 1, 1)
            x = synthesis_layer(p, f"{b}.conv1", x, bw[0], noises[at], f)
        else:
            x = synthesis_layer(p, f"{b}.conv0", x, bw[0], noises[at], f, up=True)
            x = synthesis_layer(p, f"{b}.conv1", x, bw[1], noises[at + 1], f)
        at += n
        y = torgb(p, f"{b}.torgb", x, bw[-1], f)
        img = y if img is None else upfirdn2d(img, f, up=2, pad=(2, 1, 2, 1), gain=4.0) + y
    return img


def conv_layer(p, name, x, f, act=True, down=False, gain=1.0, bias=True):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    w = w * (1.0 / math.sqrt(w.shape[1] * k * k))
    if down and k == 1:
        x = F.conv2d(upfirdn2d(x, f, down=2, pad=(1, 1, 1, 1)), w)
    elif down:
        x = F.conv2d(upfirdn2d(x, f, pad=(2, 2, 2, 2)), w, stride=2)
    else:
        x = F.conv2d(x, w, padding=k // 2)
    if bias:
        x = x + p[f"{name}.bias"].view(1, -1, 1, 1)
    return lrelu(x, gain) if act else x * gain


def minibatch_std(x, group):
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, -1, 1, c, h, w)
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=[2, 3, 4]).reshape(-1, 1, 1, 1)
    return torch.cat([x, y.repeat(g, 1, h, w)], dim=1)


def discriminator(s, p, img):
    f = fir_filter(img.device)
    x = None
    for res in block_resolutions(s)[:0:-1]:
        b = f"b{res}"
        if x is None:
            x = conv_layer(p, f"{b}.fromrgb", img, f)
        y = conv_layer(p, f"{b}.skip", x, f, act=False, down=True, gain=math.sqrt(0.5), bias=False)
        x = conv_layer(p, f"{b}.conv0", x, f)
        x = conv_layer(p, f"{b}.conv1", x, f, down=True, gain=math.sqrt(0.5))
        x = y + x
    x = conv_layer(p, "b4.conv", minibatch_std(x, s["mbstd_group"]), f)
    x = fc(p, "b4.fc", x.flatten(1))
    return fc(p, "b4.out", x, act=False)
