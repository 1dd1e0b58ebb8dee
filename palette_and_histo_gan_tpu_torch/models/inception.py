"""InceptionV3 feature extractor for FID, as an `nn.Module`.

Counterpart of palette_and_histo_gan_tpu/models/inception.py: the keras
InceptionV3(include_top=False, pooling="avg") the reference builds for its
FID. conv + BN (no scale, eps 1e-3) + ReLU units, mixed0-10 blocks, global
average pooling to 2048 features. NHWC float32 in, NCHW inside, (B, 2048)
float32 out.

The 94 units are numbered in the order the forward first reaches them,
which is the order flax numbers `ConvBN_k` and keras creates its
Conv2D/BatchNormalization pairs, so `units[k]` is the weight file's
`params/ConvBN_{k}`. The architecture is written once (`_graph`): the
constructor runs it on meta tensors to create the units, the forward runs
it again to apply them in the same order.

Weights (`load_params`): the flat `.npz` that `PHG_INCEPTION_WEIGHTS` names,
loaded strictly; with the variable unset, a He-normal initialization drawn
with numpy from seed 0, the same on every device. `convert_keras_model`
writes that layout from a live keras InceptionV3, and
`convert_keras_weights` from a keras notop weights file (the command
`python -m palette_and_histo_gan_tpu_torch.convert_inception`); only the
latter needs TensorFlow, which it imports when called.
"""

from __future__ import annotations

import os
import re
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEATURE_DIM = 2048
NUM_CONVBN = 94  # conv2d_bn units of keras InceptionV3 (stem 5 + mixed0-10)
BN_EPS = 1e-3
MIN_INPUT_SIZE = 75  # keras InceptionV3's smallest input; mixed 8 ends at 1x1
WEIGHTS_ENV = "PHG_INCEPTION_WEIGHTS"
RANDOM_INIT_SEED = 0


class ConvBN(nn.Module):
    """Conv (no bias) + inference BatchNorm (no scale) + ReLU, keras
    conv2d_bn. `VALID` pads nothing; `SAME` occurs only at stride 1 with odd
    kernels, where its padding is symmetric, (k_h // 2, k_w // 2)."""

    def __init__(self, in_channels: int, filters: int, kernel: tuple[int, int],
                 strides: int = 1, padding: str = "SAME"):
        super().__init__()
        if padding == "SAME" and (strides != 1 or kernel[0] % 2 == 0 or kernel[1] % 2 == 0):
            raise ValueError(f"SAME needs stride 1 and an odd kernel, got {kernel} / {strides}")
        self.stride = strides
        self.padding = (kernel[0] // 2, kernel[1] // 2) if padding == "SAME" else (0, 0)
        self.weight = nn.Parameter(torch.zeros(filters, in_channels, *kernel))
        self.register_buffer("mean", torch.zeros(filters))
        self.register_buffer("var", torch.ones(filters))
        self.register_buffer("beta", torch.zeros(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W) float32
        x = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        scale = torch.rsqrt(self.var + BN_EPS)
        x = (x - self.mean[:, None, None]) * scale[:, None, None] + self.beta[:, None, None]
        return F.relu(x)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)  # 3x3, stride 2, VALID


def _avgpool(x: torch.Tensor) -> torch.Tensor:
    # 3x3, stride 1, SAME, divided by the window's valid elements as keras
    # AveragePooling2D does on the borders
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


# a unit's application: (x, filters, kernel, strides, padding) -> y
Unit = Callable[..., torch.Tensor]


def _graph(x: torch.Tensor, unit: Unit) -> torch.Tensor:
    """InceptionV3 up to mixed 10 (NCHW), each conv+BN unit through `unit`
    in the order of the JAX module's __call__; concatenations keep its
    branch order."""
    # stem
    x = unit(x, 32, (3, 3), 2, "VALID")
    x = unit(x, 32, (3, 3), 1, "VALID")
    x = unit(x, 64, (3, 3))
    x = _maxpool(x)
    x = unit(x, 80, (1, 1), 1, "VALID")
    x = unit(x, 192, (3, 3), 1, "VALID")
    x = _maxpool(x)

    # mixed 0-2: 35x35 blocks
    for pool_proj in (32, 64, 64):
        b1 = unit(x, 64, (1, 1))
        b5 = unit(x, 48, (1, 1))
        b5 = unit(b5, 64, (5, 5))
        b3 = unit(x, 64, (1, 1))
        b3 = unit(b3, 96, (3, 3))
        b3 = unit(b3, 96, (3, 3))
        bp = unit(_avgpool(x), pool_proj, (1, 1))
        x = torch.cat([b1, b5, b3, bp], dim=1)

    # mixed 3: reduction to 17x17
    b3 = unit(x, 384, (3, 3), 2, "VALID")
    bd = unit(x, 64, (1, 1))
    bd = unit(bd, 96, (3, 3))
    bd = unit(bd, 96, (3, 3), 2, "VALID")
    x = torch.cat([b3, bd, _maxpool(x)], dim=1)

    # mixed 4-7: 17x17 blocks with factorized 7x7
    for width in (128, 160, 160, 192):
        b1 = unit(x, 192, (1, 1))
        b7 = unit(x, width, (1, 1))
        b7 = unit(b7, width, (1, 7))
        b7 = unit(b7, 192, (7, 1))
        bd = unit(x, width, (1, 1))
        bd = unit(bd, width, (7, 1))
        bd = unit(bd, width, (1, 7))
        bd = unit(bd, width, (7, 1))
        bd = unit(bd, 192, (1, 7))
        bp = unit(_avgpool(x), 192, (1, 1))
        x = torch.cat([b1, b7, bd, bp], dim=1)

    # mixed 8: reduction to 8x8
    b3 = unit(x, 192, (1, 1))
    b3 = unit(b3, 320, (3, 3), 2, "VALID")
    b7 = unit(x, 192, (1, 1))
    b7 = unit(b7, 192, (1, 7))
    b7 = unit(b7, 192, (7, 1))
    b7 = unit(b7, 192, (3, 3), 2, "VALID")
    x = torch.cat([b3, b7, _maxpool(x)], dim=1)

    # mixed 9-10: 8x8 blocks with split branches
    for _ in range(2):
        b1 = unit(x, 320, (1, 1))
        b3 = unit(x, 384, (1, 1))
        b3 = torch.cat([unit(b3, 384, (1, 3)), unit(b3, 384, (3, 1))], dim=1)
        bd = unit(x, 448, (1, 1))
        bd = unit(bd, 384, (3, 3))
        bd = torch.cat([unit(bd, 384, (1, 3)), unit(bd, 384, (3, 1))], dim=1)
        bp = unit(_avgpool(x), 192, (1, 1))
        x = torch.cat([b1, b3, bd, bp], dim=1)
    return x


class InceptionV3(nn.Module):
    """Pool-3 (2048-d pooled) feature extractor: (B, H, W, 3) NHWC float32
    -> (B, 2048) float32."""

    def __init__(self):
        super().__init__()
        self.units = nn.ModuleList()

        def create(x, filters, kernel, strides=1, padding="SAME"):
            u = ConvBN(x.shape[1], filters, kernel, strides, padding)
            self.units.append(u)
            # the output's shape only: x lies on the meta device
            return F.conv2d(x, u.weight.to("meta"), stride=u.stride, padding=u.padding)

        with torch.no_grad():
            _graph(torch.empty(1, 3, MIN_INPUT_SIZE, MIN_INPUT_SIZE, device="meta"), create)
        if len(self.units) != NUM_CONVBN:
            raise AssertionError(f"{len(self.units)} units, expected {NUM_CONVBN}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        units = iter(self.units)
        x = _graph(x.float().permute(0, 3, 1, 2), lambda y, *spec: next(units)(y))
        return x.mean(dim=(2, 3))


def conv_flops(model: InceptionV3, input_size: int = 299) -> int:
    """The operations (two a multiply-add) of the 94 convolutions for one
    image of input_size pixels a side: the conv part of the forward's
    work, from the shapes alone (meta tensors)."""
    units = iter(model.units)
    total = 0

    def count(x, *spec):
        nonlocal total
        u = next(units)
        y = F.conv2d(x, u.weight.to("meta"), stride=u.stride, padding=u.padding)
        total += 2 * y[0].numel() * u.weight[0].numel()
        return y

    with torch.no_grad():
        _graph(torch.empty(1, 3, input_size, input_size, device="meta"), count)
    return total


def random_flat_params(module: InceptionV3, seed: int = RANDOM_INIT_SEED) -> dict:
    """A flat weight dict in the file's layout: He-normal HWIO kernels
    (std sqrt(2 / fan_in)) drawn with numpy's default_rng(seed) unit by unit
    in creation order, BN at mean 0, var 1, beta 0."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, u in enumerate(module.units):
        out_c, in_c, kh, kw = u.weight.shape
        std = np.sqrt(2.0 / (kh * kw * in_c))
        kernel = rng.standard_normal((kh, kw, in_c, out_c), dtype=np.float32) * np.float32(std)
        prefix = f"params/ConvBN_{k}"
        flat[f"{prefix}/Conv_0/kernel"] = kernel
        flat[f"{prefix}/mean"] = np.zeros(out_c, np.float32)
        flat[f"{prefix}/var"] = np.ones(out_c, np.float32)
        flat[f"{prefix}/beta"] = np.zeros(out_c, np.float32)
    return flat


def load_params(input_size: int = 299, device: torch.device | str = "cuda") -> InceptionV3:
    """InceptionV3 in eval mode on `device`, for inputs of `input_size`
    pixels a side: pretrained from the .npz that PHG_INCEPTION_WEIGHTS
    names (strict: a missing, extra or mis-shaped key raises), or, with
    the variable unset, random (`random_flat_params`). A variable that
    names no file raises: a FID of random weights is never reported in
    place of a pretrained one."""
    from .convert import inception_state_dict_from_flat

    if input_size < MIN_INPUT_SIZE:
        raise ValueError(f"InceptionV3 needs inputs of at least {MIN_INPUT_SIZE} pixels, "
                         f"got {input_size}")
    model = InceptionV3()
    path = os.environ.get(WEIGHTS_ENV, "")
    if path:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{WEIGHTS_ENV}={path!r} names no file")
        with np.load(path) as f:
            flat = {k: f[k] for k in f.files}
    else:
        print(f"InceptionV3 for FID with random weights ({WEIGHTS_ENV} unset): the values "
              "are not comparable to a pretrained FID")
        flat = random_flat_params(model)
    model.load_state_dict(inception_state_dict_from_flat(flat, model))
    return model.to(device).eval()


def _layers_in_creation_order(keras_model, cls_name: str) -> list:
    """Layers of one class sorted by the numeric suffix keras appends at
    creation time ('conv2d', 'conv2d_1', ...: monotone in creation order
    even when the session's name counters started above zero)."""
    layers = [l for l in keras_model.layers if l.__class__.__name__ == cls_name]

    def creation_index(layer):
        m = re.search(r"_(\d+)$", layer.name)
        return int(m.group(1)) if m else -1

    return sorted(layers, key=creation_index)


def convert_keras_model(keras_model) -> dict:
    """The flat weight dict of `load_params` (params/ConvBN_k/...) from a
    live keras InceptionV3 (include_top=False).

    keras' inception_v3.conv2d_bn creates each Conv2D and its
    BatchNormalization together, in the order `_graph` reaches its units,
    so the k-th created pair is `units[k]`. Pairs are matched by the
    creation index in the layer names, not by `model.layers`' topological
    order."""
    conv_layers = _layers_in_creation_order(keras_model, "Conv2D")
    bn_layers = _layers_in_creation_order(keras_model, "BatchNormalization")
    if len(conv_layers) != NUM_CONVBN or len(bn_layers) != NUM_CONVBN:
        raise ValueError(
            f"expected {NUM_CONVBN} Conv2D/BatchNormalization pairs, got "
            f"{len(conv_layers)}/{len(bn_layers)}: not a notop InceptionV3?"
        )
    flat = {}
    for k, (cl, bl) in enumerate(zip(conv_layers, bn_layers)):
        prefix = f"params/ConvBN_{k}"
        (kernel,) = cl.get_weights()  # use_bias=False in conv2d_bn
        # BN has scale=False, center=True: its weights are [beta, mean, variance]
        beta, mean, var = bl.get_weights()
        if kernel.shape[-1] != beta.shape[0]:
            raise ValueError(f"conv/bn channel mismatch at unit {k}: {cl.name} vs {bl.name}")
        flat[f"{prefix}/Conv_0/kernel"] = kernel
        flat[f"{prefix}/beta"] = beta
        flat[f"{prefix}/mean"] = mean
        flat[f"{prefix}/var"] = var
    return flat


def convert_keras_weights(h5_path: str, out_npz: str) -> None:
    """Convert a keras InceptionV3 notop weights file on disk into the
    `.npz` that `load_params` reads. Needs TensorFlow, imported here."""
    import tensorflow as tf

    keras_model = tf.keras.applications.InceptionV3(
        include_top=False, pooling="avg", weights=h5_path
    )
    np.savez(out_npz, **convert_keras_model(keras_model))
