"""The matrix FLOPs of HistoGAN's training (reference/histogan_nets.py,
reference/histogan_step.py), from the widths: what torch.utils.
flop_counter.FlopCounterMode counts over the reference's steps
(convolutions, transposed and depthwise ones included, and matrix
products; 2 a multiply-add), per image of one lazy period.

Each operation is a record of its forward FLOPs an image and which
gradients its backward computes: `gi` of its input (where the input
needs one), `gw` of its weight (where the weight is a parameter; the FIR
filter is not). Then per phase, at its batch:
  * Gmain: G forward (the mapping twice, z and z_mix, the projection, the
    synthesis), D forward, the fakes' histogram; backward: G's gi and gw,
    D's gi (its parameters are not trained in the phase);
  * Dmain: G forward without gradient; D forward twice (fakes, reals),
    each with D's backward, gw and gi but the first layer's gi (the images
    need no gradient);
  * Greg (batch / pl_batch_shrink) and Dreg: the forward; the first-order
    gradients towards the styles or the image (create_graph): every gi on
    that path; then the backward of the penalty, which runs the whole
    network's backward (gi and gw: `img * 0` and `logits * 0` keep every
    parameter in the graph; Dreg's asks no gradient of the image) and, for
    each operation of the first-order pass, its double backward: two
    products of a forward's FLOPs (one where that operation's output
    gradient was a constant: D's last layer's, the logits' sum's);
  * the histograms: the reals' forward once a step; the fakes' forward,
    then in the backward the forward again (the reference recomputes it)
    and the two products of the forward's backward.
A period is lcm(g_reg_interval, d_reg_interval) steps: Gmain and Dmain in
each, Greg in period / g_reg_interval, Dreg in period / d_reg_interval.
"""

from __future__ import annotations

import math


def _res(s):
    return [2**i for i in range(2, int(math.log2(s["resolution"])) + 1)]


def _ch(s, res):
    return min(s["channel_base"] // res, s["channel_max"])


def _fir(c, out_side):
    return 2.0 * c * 16 * out_side**2


def _affine(fin, fout):
    return [(2.0 * fin * fout, True, True, "path")]


def generator_ops(s):
    """(mapping, projection, synthesis): lists of (flops an image, gi, gw,
    role); role "path" where the styles' first-order gradient runs
    through it (synthesis), "off" where it does not."""
    w = s["w_dim"]
    dims = [s["z_dim"]] + [w] * s["mapping_layers"]
    mapping = [(2.0 * dims[i] * dims[i + 1], i > 0, True, "off")
               for i in range(s["mapping_layers"])]
    pd = [3 * s["histogram_size"] ** 2] + list(s["projection_widths"][:-1]) + [w]
    projection = [(2.0 * pd[i] * pd[i + 1], i > 0, True, "off")
                  for i in range(len(s["projection_widths"]))]
    syn = []
    for res in _res(s):
        c = _ch(s, res)
        if res > 4:
            cin = _ch(s, res // 2)
            syn += _affine(w, cin)  # conv0's affine
            syn.append((2.0 * cin * c * 9 * (res // 2) ** 2, True, True, "path"))  # transposed
            syn.append((_fir(c, res), True, False, "path"))
        syn += _affine(w, c)  # conv1's affine
        syn.append((2.0 * c * c * 9 * res**2, True, True, "path"))
        syn += _affine(w, c)  # toRGB's affine
        syn.append((2.0 * 3 * c * res**2, True, True, "path"))
        if res > 4:
            syn.append((_fir(3, res), True, False, "path"))  # the image's upsampling
    return mapping, projection, syn


def discriminator_ops(s):
    """The discriminator's operations, (flops an image, gi, gw), from the
    image up; the first (fromrgb) takes the image."""
    ops = []
    top = s["resolution"]
    for res in _res(s)[:0:-1]:
        c, out = _ch(s, res), _ch(s, res // 2)
        if res == top:
            ops.append((2.0 * c * 3 * res**2, True, True))
        ops += [(_fir(c, res - 1), True, False), (2.0 * out * c * (res // 2) ** 2, True, True),  # skip
                (2.0 * c * c * 9 * res**2, True, True),  # conv0
                (_fir(c, res + 1), True, False), (2.0 * out * c * 9 * (res // 2) ** 2, True, True)]
    c4 = _ch(s, 4)
    ops += [(2.0 * c4 * (c4 + 1) * 9 * 16, True, True), (2.0 * c4 * 16 * c4, True, True),
            (2.0 * c4, True, True)]
    return ops


def _backward(ops, weights=True, inputs=True):
    return sum(f * ((gi and inputs) + (gw and weights)) for f, gi, gw, *_ in ops)


def histogram_flops(s) -> float:
    """One forward's products an image: 3 planes of (size x HW) (HW x size)."""
    side = min(s["resolution"], s["histogram_resize"])
    return 2.0 * 3 * s["histogram_size"] ** 2 * side * side


def phase_flops(s) -> dict:
    """FLOPs an image of each phase at its own batch, and of a step's
    histogram of the reals."""
    mapping, projection, syn = generator_ops(s)
    g_ops = mapping + mapping + projection + syn  # z and z_mix
    g_fwd = sum(op[0] for op in g_ops)
    d_ops = discriminator_ops(s)
    d_fwd = sum(op[0] for op in d_ops)
    h = histogram_flops(s)
    g_main = g_fwd + _backward(g_ops) + d_fwd + _backward(d_ops, weights=False) + 4 * h
    d_main = g_fwd + 2 * (d_fwd + _backward(d_ops) - d_ops[0][0])  # no gi of the image
    path = [op for op in syn if op[3] == "path"]
    g_reg = (g_fwd + _backward(path, weights=False) + _backward(g_ops)
             + 2 * sum(op[0] for op in path))
    # the second pass asks no gradient of the image, and the last layer's
    # output gradient in the first pass is a constant (the logits' sum)
    d_reg = (d_fwd + _backward(d_ops, weights=False) + _backward(d_ops) - d_ops[0][0]
             + 2 * d_fwd - d_ops[-1][0])
    return {"Gmain": g_main, "Greg": g_reg, "Dmain": d_main, "Dreg": d_reg, "hist_real": h}


def flops_per_image(s) -> float:
    """One lazy period's FLOPs over its images (period x batch): Gmain,
    Dmain and the reals' histogram every step, Greg on 1 / pl_batch_shrink
    of the images every g_reg_interval steps, Dreg every d_reg_interval."""
    p = phase_flops(s)
    return (p["Gmain"] + p["Dmain"] + p["hist_real"]
            + p["Greg"] / (s["g_reg_interval"] * s["pl_batch_shrink"])
            + p["Dreg"] / s["d_reg_interval"])
