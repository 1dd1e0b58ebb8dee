"""HistoGAN (Afifi et al., arXiv:2011.11731) on the StyleGAN2 backbone
(Karras et al., arXiv:1912.04958), as stylegan2-ada-pytorch's `paper256`
configuration sets its widths: the networks and their configuration.

  * `MappingNetwork`: z normalized to unit second moment, eight
    fully-connected layers of width `w_dim` (learning-rate multiplier
    0.01), the running mean of w (`w_avg`, a buffer);
  * `HistogramProjection`: the target's RGB-uv histogram (3 x 64 x 64,
    flattened plane by plane) through eight fully-connected layers (1,024
    wide, then 512), each followed by a leaky ReLU: the w of the last
    `histogram_blocks` synthesis blocks;
  * `SynthesisNetwork`: a learned 4x4 constant, then one block a
    resolution up to `resolution`, each a modulated 3x3 convolution that
    upsamples (FIR [1, 3, 3, 1]), a modulated 3x3 convolution, and a
    modulated 1x1 toRGB whose image is added to the upsampled image of the
    block below ("skip"); noise inputs with a learned strength; bias, then
    leaky ReLU 0.2 times sqrt(2);
  * `Discriminator`: one residual block a resolution from `resolution`
    down to 8 (3x3, 3x3 that downsamples, a 1x1 skip that downsamples,
    both paths times sqrt(1/2)), then the 4x4 epilogue: minibatch
    standard deviation over groups of `mbstd_group`, a 3x3 convolution
    and two fully-connected layers.

Every weight is drawn N(0, 1) (N(0, 1 / multiplier) where a layer has a
learning-rate multiplier) and scaled at run time (equalized learning
rate). A modulated convolution runs as StyleGAN2 trains it: the input
scaled by the styles, one convolution with the shared weight, the output
scaled by the demodulation coefficients; the coefficients
rsqrt(sum over (in, kh, kw) of (weight x style)^2 + 1e-8) are computed as
one product (styles^2) @ (sum over the kernel of weight^2)^T.

Channels at resolution r are min(channel_base / r, channel_max): 512 at
4-32, 256 at 64, 128 at 128, 64 at 256 in `paper256`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)
LRELU_SLOPE = 0.2
FIR_TAPS = (1.0, 3.0, 3.0, 1.0)


@dataclasses.dataclass(frozen=True)
class HistoGANConfig:
    """The widths and the training recipe (stylegan2-ada-pytorch
    `--cfg=paper256 --fp32=True --aug=noaug`, HistoGAN's histogram head and
    loss). `batch_size` is the minibatch of one step."""

    resolution: int = 256
    z_dim: int = 512
    w_dim: int = 512
    mapping_layers: int = 8
    mapping_lr_multiplier: float = 0.01
    w_avg_beta: float = 0.995
    channel_base: int = 16384
    channel_max: int = 512
    mbstd_group: int = 8
    # the histogram: RGB-uv, its bins, kernel and sigma; images wider than
    # histogram_resize are resized to it (bilinear) first
    histogram_size: int = 64
    histogram_method: str = "inverse-quadratic"
    histogram_sigma: float = 0.02
    histogram_resize: int = 150
    projection_widths: tuple = (1024, 512, 512, 512, 512, 512, 512, 512)
    histogram_blocks: int = 2
    lambda_histogram: float = 1.0
    # Adam in torch's eps convention; lazy regularization corrects lr and
    # betas by interval / (interval + 1)
    learning_rate: float = 0.0025
    beta1: float = 0.0
    beta2: float = 0.99
    adam_eps: float = 1e-8
    r1_gamma: float = 1.0
    d_reg_interval: int = 16
    pl_weight: float = 2.0
    g_reg_interval: int = 4
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    style_mixing: float = 0.9
    ema_kimg: float = 20.0
    batch_size: int = 64
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError("HistoGAN runs in float32 only (TF32 off)")
        log2 = int(math.log2(self.resolution))
        if self.resolution != 2**log2 or self.resolution < 8:
            raise ValueError(f"resolution must be a power of two >= 8, got {self.resolution}")
        if not 0 < self.histogram_blocks < log2 - 1:
            raise ValueError(f"histogram_blocks must leave a mapped block, got {self.histogram_blocks}")
        if len(self.projection_widths) < 1:
            raise ValueError("the histogram projection needs a layer")
        object.__setattr__(self, "projection_widths", tuple(self.projection_widths))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def block_resolutions(self) -> tuple:
        return tuple(2**i for i in range(2, int(math.log2(self.resolution)) + 1))

    @property
    def mapped_blocks(self) -> int:
        """The synthesis blocks styled by the mapping network, from 4 up."""
        return len(self.block_resolutions) - self.histogram_blocks

    @property
    def num_ws(self) -> int:
        """The mapped w's: block 4 takes w 0 (its conv) and 1 (toRGB);
        block i > 0 takes 2i - 1, 2i (its convs) and 2i + 1 (toRGB)."""
        return 2 * self.mapped_blocks

    @property
    def noise_resolutions(self) -> tuple:
        """The resolution of each noise input, in the layers' order."""
        return tuple(r for res in self.block_resolutions for r in ((res,) if res == 4 else (res, res)))

    @property
    def histogram_side(self) -> int:
        return min(self.resolution, self.histogram_resize)


# ------------------------------------------------ convolutions of any order
#
# PyTorch's own double backward of a convolution computes the weight term
# as a convolution whose filter is the output gradient (as large as the
# image), which cuDNN runs on a slow implicit-GEMM kernel; the path-length
# and R1 phases differentiate every convolution twice. As
# stylegan2-ada-pytorch's torch_utils/ops/conv2d_gradfix.py does, the
# convolutions here are autograd Functions whose gradients are again such
# Functions: the input's gradient the transposed convolution, the
# weight's `aten.convolution_backward` (cuDNN's weight gradient), at any
# order. `no_weight_gradients()` skips the weight gradients (the
# path-length phase's first-order pass, which wants the styles' only).

_weight_gradients = [True]


@contextlib.contextmanager
def no_weight_gradients():
    _weight_gradients.append(False)
    try:
        yield
    finally:
        _weight_gradients.pop()


@functools.lru_cache(maxsize=None)
def _conv_op(transpose: bool, weight_shape: tuple, stride: int, padding: int,
             output_padding: tuple, groups: int):
    kw = dict(stride=stride, padding=padding, groups=groups)

    def output_padding_of(input_shape, output_shape):
        if transpose:
            return (0, 0)
        return tuple(input_shape[i + 2] - (output_shape[i + 2] - 1) * stride + 2 * padding
                     - weight_shape[i + 2] for i in range(2))

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x if w.requires_grad else None, w if x.requires_grad else None)
            ctx.input_shape = x.shape
            if transpose:
                return F.conv_transpose2d(x, w, output_padding=output_padding, **kw)
            return F.conv2d(x, w, **kw)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            gx = gw = None
            if ctx.needs_input_grad[0]:
                op = _conv_op(not transpose, weight_shape, stride, padding,
                              output_padding_of(ctx.input_shape, g.shape), groups)
                gx = op.apply(g, w)
            if ctx.needs_input_grad[1] and _weight_gradients[-1]:
                gw = GradWeight.apply(g, x)
            return gx, gw

    class GradWeight(torch.autograd.Function):
        @staticmethod
        def forward(ctx, g, x):
            ctx.save_for_backward(g if x.requires_grad else None, x if g.requires_grad else None)
            ctx.g_shape, ctx.input_shape = g.shape, x.shape
            empty = torch.empty(weight_shape, dtype=x.dtype, device=x.device)
            return torch.ops.aten.convolution_backward(
                g, x, empty, None, (stride, stride), (padding, padding), (1, 1), transpose,
                output_padding, groups, (False, True, False))[1]

        @staticmethod
        def backward(ctx, gg):
            g, x = ctx.saved_tensors
            g2 = x2 = None
            if ctx.needs_input_grad[0]:
                g2 = Conv.apply(x, gg)
            if ctx.needs_input_grad[1]:
                op = _conv_op(not transpose, weight_shape, stride, padding,
                              output_padding_of(ctx.input_shape, ctx.g_shape), groups)
                x2 = op.apply(g, gg)
            return g2, x2

    return Conv


def conv2d(x, w, stride: int = 1, padding: int = 0, groups: int = 1):
    return _conv_op(False, tuple(w.shape), stride, padding, (0, 0), groups).apply(x, w)


def conv_transpose2d(x, w, stride: int = 1, padding: int = 0, groups: int = 1):
    return _conv_op(True, tuple(w.shape), stride, padding, (0, 0), groups).apply(x, w)


def fir_filter(device=None) -> torch.Tensor:
    """The 4x4 FIR [1, 3, 3, 1] outer product, normalized to sum 1."""
    f = torch.tensor(FIR_TAPS, device=device)
    f = torch.outer(f, f)
    return f / f.sum()


def fir(x: torch.Tensor, f: torch.Tensor, pad: int, gain: float = 1.0, stride: int = 1):
    """The FIR filter over each channel of NCHW `x`, padded by `pad` zeros
    on every side; `stride` 2 keeps every second output (downsampling)."""
    c = x.shape[1]
    w = (f * gain).expand(c, 1, *f.shape).contiguous()
    return conv2d(x, w, stride=stride, padding=pad, groups=c)


def upsample_image(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """2x upsampling by the FIR (zeros between the pixels, the filter times
    4): one transposed depthwise convolution."""
    c = img.shape[1]
    return conv_transpose2d(img, (f * 4.0).expand(c, 1, *f.shape).contiguous(), stride=2, padding=1,
                            groups=c)


def bias_act(x: torch.Tensor, b: torch.Tensor | None, act: bool, gain: float = 1.0):
    """x + b (over dim 1), leaky ReLU 0.2 times sqrt(2) where `act`, times
    `gain`."""
    if b is not None:
        x = x + (b if x.dim() == 2 else b.view(1, -1, 1, 1))
    if act:
        return F.leaky_relu(x, LRELU_SLOPE) * (SQRT2 * gain)
    return x if gain == 1.0 else x * gain


class FullyConnected(nn.Module):
    def __init__(self, fin: int, fout: int, act: bool = True, lr_multiplier: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(fout, fin) / lr_multiplier)
        self.bias = nn.Parameter(torch.full((fout,), float(bias_init)))
        self.act = act
        self.weight_gain = lr_multiplier / math.sqrt(fin)
        self.bias_gain = lr_multiplier

    def forward(self, x):
        w = self.weight * self.weight_gain
        b = self.bias * self.bias_gain if self.bias_gain != 1.0 else self.bias
        if not self.act:
            return torch.addmm(b.unsqueeze(0), x, w.t())
        return bias_act(x.matmul(w.t()), b, True)


class MappingNetwork(nn.Module):
    def __init__(self, cfg: HistoGANConfig):
        super().__init__()
        self.beta = cfg.w_avg_beta
        dims = [cfg.z_dim] + [cfg.w_dim] * cfg.mapping_layers
        for i in range(cfg.mapping_layers):
            setattr(self, f"fc{i}", FullyConnected(dims[i], dims[i + 1],
                                                   lr_multiplier=cfg.mapping_lr_multiplier))
        self.layers = cfg.mapping_layers
        self.register_buffer("w_avg", torch.zeros(cfg.w_dim))

    def forward(self, z, update_w_avg: bool):
        x = z * (z.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()
        for i in range(self.layers):
            x = getattr(self, f"fc{i}")(x)
        if update_w_avg:
            with torch.no_grad():
                self.w_avg.copy_(x.detach().mean(dim=0).lerp(self.w_avg, self.beta))
        return x


class HistogramProjection(nn.Module):
    def __init__(self, cfg: HistoGANConfig):
        super().__init__()
        dims = (3 * cfg.histogram_size**2,) + cfg.projection_widths[:-1] + (cfg.w_dim,)
        self.layers = len(cfg.projection_widths)
        for i in range(self.layers):
            setattr(self, f"fc{i}", FullyConnected(dims[i], dims[i + 1]))

    def forward(self, hist_flat):
        x = hist_flat
        for i in range(self.layers):
            x = getattr(self, f"fc{i}")(x)
        return x


def modulated_conv(x, weight, styles, up: bool, f: torch.Tensor):
    """The modulated 3x3 convolution before its demodulation: x scaled by
    the styles, convolved with the shared weight (upsampling: transposed
    at stride 2, then the FIR times 4, padded 1)."""
    x = x * styles[:, :, None, None]
    if up:
        x = conv_transpose2d(x, weight.transpose(0, 1), stride=2)
        return fir(x, f, pad=1, gain=4.0)
    return conv2d(x, weight, padding=weight.shape[-1] // 2)


def demodulation(weight, styles):
    """(B, out) rsqrt(sum over (in, kh, kw) of (weight x style)^2 + 1e-8)."""
    return (styles.square() @ weight.square().sum(dim=(2, 3)).t() + 1e-8).rsqrt()


class SynthesisLayer(nn.Module):
    def __init__(self, cin: int, cout: int, w_dim: int, up: bool):
        super().__init__()
        self.affine = FullyConnected(w_dim, cin, act=False, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.noise_strength = nn.Parameter(torch.zeros([]))
        self.up = up

    def forward(self, x, w, noise, f):
        styles = self.affine(w)
        y = modulated_conv(x, self.weight, styles, self.up, f)
        y = torch.addcmul(noise * self.noise_strength, y,
                          demodulation(self.weight, styles)[:, :, None, None])
        return bias_act(y, self.bias, True)


class ToRGB(nn.Module):
    def __init__(self, cin: int, w_dim: int):
        super().__init__()
        self.affine = FullyConnected(w_dim, cin, act=False, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(3, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(3))
        self.weight_gain = 1.0 / math.sqrt(cin)

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        return bias_act(conv2d(x * styles[:, :, None, None], self.weight), self.bias, False)


class SynthesisBlock(nn.Module):
    def __init__(self, cin: int, cout: int, w_dim: int, res: int):
        super().__init__()
        if res == 4:
            self.const = nn.Parameter(torch.randn(cout, 4, 4))
        else:
            self.conv0 = SynthesisLayer(cin, cout, w_dim, up=True)
        self.conv1 = SynthesisLayer(cout, cout, w_dim, up=False)
        self.torgb = ToRGB(cout, w_dim)
        self.res = res

    def forward(self, x, img, ws, noises, f):
        """`ws`: the w of each layer, (conv1, torgb) at 4, (conv0, conv1,
        torgb) above; `noises` those of the convolutions."""
        if self.res == 4:
            x = self.conv1(self.const.unsqueeze(0).expand(ws[0].shape[0], -1, -1, -1),
                           ws[0], noises[0], f)
        else:
            x = self.conv0(x, ws[0], noises[0], f)
            x = self.conv1(x, ws[1], noises[1], f)
        y = self.torgb(x, ws[-1])
        return x, (y if img is None else upsample_image(img, f) + y)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: HistoGANConfig):
        super().__init__()
        self.cfg = cfg
        for res in cfg.block_resolutions:
            cin = cfg.channels(res // 2) if res > 4 else 0
            setattr(self, f"b{res}", SynthesisBlock(cin, cfg.channels(res), cfg.w_dim, res))
        self.register_buffer("fir", fir_filter(), persistent=False)

    def forward(self, ws, w_hist, noises):
        """ws (B, num_ws, w_dim) of the mapped blocks, w_hist (B, w_dim) of
        the histogram's blocks, noises in the layers' order -> (B, 3, R, R)."""
        x = img = None
        at = 0
        for i, res in enumerate(self.cfg.block_resolutions):
            n = 1 if res == 4 else 2
            if i < self.cfg.mapped_blocks:
                first = 0 if res == 4 else 2 * i - 1
                block_ws = ws.unbind(dim=1)[first:first + n + 1]
            else:
                block_ws = (w_hist,) * (n + 1)
            x, img = getattr(self, f"b{res}")(x, img, block_ws, noises[at:at + n], self.fir)
            at += n
        return img


class Generator(nn.Module):
    def __init__(self, cfg: HistoGANConfig):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(cfg)
        self.projection = HistogramProjection(cfg)
        self.synthesis = SynthesisNetwork(cfg)

    def styles(self, z, z_mix, cutoff, hist_flat):
        """The mapped ws (B, num_ws, w_dim), those from layer `cutoff` (a
        0-dim float tensor, num_ws for none) on mapped from z_mix, and
        the histogram's w (B, w_dim); z's w updates w_avg."""
        num_ws = self.cfg.num_ws
        w = self.mapping(z, True)
        w_mix = self.mapping(z_mix, False)
        later = torch.arange(num_ws, device=z.device, dtype=cutoff.dtype) >= cutoff
        ws = torch.where(later[None, :, None], w_mix[:, None, :], w[:, None, :])
        return ws, self.projection(hist_flat)


class Conv2dLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, act: bool = True, down: bool = False,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.act, self.down = act, down
        self.weight_gain = 1.0 / math.sqrt(cin * k * k)

    def forward(self, x, f, gain: float = 1.0):
        w = self.weight * self.weight_gain
        k = w.shape[-1]
        if self.down and k == 1:
            x = conv2d(fir(x, f, pad=1, stride=2), w)
        elif self.down:
            x = conv2d(fir(x, f, pad=2), w, stride=2)
        else:
            x = conv2d(x, w, padding=k // 2)
        return bias_act(x, self.bias, self.act, gain)


class DiscriminatorBlock(nn.Module):
    def __init__(self, cin: int, tmp: int, cout: int):
        super().__init__()
        if cin == 0:
            self.fromrgb = Conv2dLayer(3, tmp, 1)
        self.conv0 = Conv2dLayer(tmp, tmp, 3)
        self.conv1 = Conv2dLayer(tmp, cout, 3, down=True)
        self.skip = Conv2dLayer(tmp, cout, 1, act=False, down=True, bias=False)

    def forward(self, x, img, f):
        if img is not None:
            x = self.fromrgb(img, f)
        y = self.skip(x, f, gain=math.sqrt(0.5))
        x = self.conv1(self.conv0(x, f), f, gain=math.sqrt(0.5))
        return y + x


def minibatch_std(x, group: int):
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, -1, 1, c, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=(2, 3, 4)).reshape(-1, 1, 1, 1)
    return torch.cat([x, y.repeat(g, 1, h, w)], dim=1)


class Discriminator(nn.Module):
    def __init__(self, cfg: HistoGANConfig):
        super().__init__()
        self.cfg = cfg
        self.resolutions = cfg.block_resolutions[:0:-1]  # R .. 8
        for res in self.resolutions:
            cin = cfg.channels(res) if res < cfg.resolution else 0
            setattr(self, f"b{res}", DiscriminatorBlock(cin, cfg.channels(res), cfg.channels(res // 2)))
        c4 = cfg.channels(4)
        self.b4 = nn.Module()
        self.b4.conv = Conv2dLayer(c4 + 1, c4, 3)
        self.b4.fc = FullyConnected(c4 * 16, c4)
        self.b4.out = FullyConnected(c4, 1, act=False)
        self.register_buffer("fir", fir_filter(), persistent=False)

    def forward(self, img):
        x = None
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x, img if x is None else None, self.fir)
        x = self.b4.conv(minibatch_std(x, self.cfg.mbstd_group), self.fir)
        return self.b4.out(self.b4.fc(x.flatten(1)))
