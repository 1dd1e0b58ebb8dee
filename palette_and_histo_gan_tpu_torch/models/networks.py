"""U-Net generator and PatchGAN discriminator as `nn.Module`s.

Mirrors palette_and_histo_gan_tpu/models/networks.py (the reference's
networks.py:7-98):
  * DownBlock: conv k4 s2 SAME, no bias, [InstanceNorm], LeakyReLU 0.3;
  * UpBlock: transposed conv k4 s2 SAME, no bias, InstanceNorm,
    [dropout 0.5], ReLU;
  * UnetGenerator: six down, six up, the raw input as the last skip
    (:539-622), head conv k4 s1 SAME with bias, then tanh (RGBA), a
    float32 softmax over the channels (indexed: 1 input channel, 256
    outputs) or nothing ("linear": logits in the compute dtype, as flax
    returns them at :609-614);
  * PatchDiscriminator: concat([target, source]), one no-norm DownBlock(64),
    head conv k4 s1 SAME with bias, (B, 32, 32, 1) patch logits (:625-666).

The public forwards take and return NHWC like the JAX package; inside, the
tensors are NCHW views of NHWC memory (channels-last strides), so that
cuDNN runs its NHWC kernels, down to the generator's head. A (B, C, 1, 1)
tensor, the U-Net's bottleneck, is contiguous in both layouts, and
PyTorch's layout suggestion (which cuDNN follows: channels-last when the
input or the weight suggests it) reads its NCHW strides as NCHW; each
UpBlock therefore gives its input NHWC strides itself (`channels_last`) and
lays its dropout mask out like its activations. The head alone runs NCHW:
its input is written into one NCHW buffer, the skip concatenation and the
SAME padding in one copy (`_HeadInput`), and its logits are NCHW, the
layout ops/indexed_loss.py takes. `conv_transpose_layouts` counts the
UpBlocks' transposed convolutions by the layout of their input.
Dropout draws its masks from an explicit `torch.Generator`, or from a
`DropoutDraw`, which also says which rows of a larger draw a call keeps:
a data-parallel rank draws the whole batch's masks and keeps its own rows,
so that N ranks draw what one process draws (parallel/dp.py).
Parameters stay float32; `dtype` (float32 or bfloat16) is the
compute type of the convolutions and activations, as flax's `dtype=` is.
Kernels are initialized N(0, 0.02) from an explicit generator.

Every k4 s2 transposed convolution, the UpBlocks' forward and the
DownBlocks' input gradient, runs as a forward convolution: the TPU
package's subpixel lowering (`conv_transpose_k4s2`), computed from the
same (in, out, 4, 4) weight. cuDNN runs a float32 transposed convolution
as backward-data on its legacy `dgrad_engine`, in either layout: at
B=1024 on an H100 (TF32 off) 1.2-35 TFLOP/s on the six up blocks' shapes,
where its forward convolutions run at ~42. The
package's other alternative lowerings (flip-grad and swap-grad weight
gradients, padded or duplicated heads) compute the same function and are
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_RELU_SLOPE = 0.3  # keras LeakyReLU default
INSTANCE_NORM_EPS = 1e-3  # tensorflow_addons InstanceNormalization default
CONV_INIT_STD = 0.02
DROPOUT_RATE = 0.5
HEAD_PAD = (1, 2, 1, 2)  # SAME for a k4 s1 window: 1 before, 2 after, W then H

# UpBlock transposed convolutions issued with an NHWC input and with any
# other, in this process, always counted; reset_conv_transpose_layouts()
# zeroes them
conv_transpose_layouts = {"channels_last": 0, "other": 0}


def reset_conv_transpose_layouts() -> None:
    for key in conv_transpose_layouts:
        conv_transpose_layouts[key] = 0


def _nhwc_strides(shape) -> tuple:
    _, c, h, w = shape
    return (h * w * c, 1, w * c, c)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """`x` (B, C, H, W) in NHWC memory with NHWC strides. A (B, C, 1, 1)
    tensor is NHWC contiguous whatever its strides, so
    `contiguous(memory_format=torch.channels_last)` keeps NCHW strides,
    which PyTorch, and so cuDNN, take as NCHW: it is copied (B x C
    elements). The choice goes by shape, not strides, so that an exported
    program, traced on strides that need not be the run's, makes it too."""
    if x.shape[-2:] == (1, 1):
        return x.clone(memory_format=torch.channels_last)
    return x.contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class DropoutDraw:
    """Where a dropout mask comes from: `generator` draws a mask of `rows`
    rows (None: the caller's batch) and the call keeps rows `first_row`
    onward, as many as its batch has; rows past the draw keep every unit.

    Drawing the exact shape one process draws, then slicing, is what makes
    a rank's rows equal one process's on the card: CUDA's Philox values
    depend on the launch's grid, which depends on the draw's size, so a
    draw of another shape need not be a prefix or a slice of it. The
    generator advances as one process's does."""

    generator: torch.Generator
    rows: int | None = None
    first_row: int = 0

    def keep_mask(self, shape, device) -> torch.Tensor:
        rows = shape[0] if self.rows is None else self.rows
        u = torch.rand((rows, *shape[1:]), generator=self.generator, device=device)
        keep = u[self.first_row:self.first_row + shape[0]] < (1.0 - DROPOUT_RATE)
        missing = shape[0] - keep.shape[0]
        if missing:
            keep = torch.cat([keep, keep.new_ones((missing, *shape[1:]))])
        return keep


def _phase_weight(weight: torch.Tensor) -> torch.Tensor:
    """A k4 s2 SAME transposed convolution's (in, out, 4, 4) weight as the
    (4 out, in, 2, 2) weight of one stride-1 k2 convolution whose output
    channels are the four output phases (ry, rx) in the order (0, 0), (0, 1),
    (1, 0), (1, 1). out[2m + r] reads the input at m - 1 + r through tap
    3 - r and at m + r through tap 1 - r, so phase r's 2x2 window is the
    spatially flipped weight's taps r and r + 2."""
    cin, cout = weight.shape[:2]
    flipped = weight.flip(2, 3).view(cin, cout, 2, 2, 2, 2)  # (in, out, a, ry, b, rx)
    return flipped.permute(3, 5, 1, 0, 2, 4).reshape(4 * cout, cin, 2, 2)


def conv_transpose_k4s2(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """F.conv_transpose2d(x, weight, stride=2, padding=1) by a forward
    convolution (subpixel): one k2 s1 convolution over the 1-padded input
    gives each 2x2 window's four output phases, and phase (ry, rx) is the
    (H, W) block of its channels at spatial offset (ry, rx), interleaved
    into out[2m + ry, 2n + rx]. cuDNN runs a float32 transposed convolution
    as backward-data, on its legacy `dgrad_engine` in either layout; this
    runs its forward kernels. The same products summed in another order,
    and (H + 1)(W + 1) / HW of them."""
    b, _, h, w = x.shape
    c = weight.shape[1]
    y = F.conv2d(x, _phase_weight(weight), padding=1)  # (B, 4C, H + 1, W + 1)
    sb, sc, sh, sw = y.stride()
    # y[b, (2 ry + rx) C + c, m + ry, n + rx] as (B, C, H, ry, W, rx): one view
    phases = y.as_strided((b, c, h, 2, w, 2), (sb, sc, sh, 2 * c * sc + sh, sw, c * sc + sw),
                          y.storage_offset())
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last if sc == 1 else torch.contiguous_format)
    out.view(b, c, h, 2, w, 2).copy_(phases)
    return out


def _weight_grad(grad, x, weight, transposed: bool) -> torch.Tensor:
    return torch.ops.aten.convolution_backward(
        grad, x, weight, None, [2, 2], [1, 1], [1, 1], transposed, [0, 0], 1,
        [False, True, False])[1]


class _ConvK4S2(torch.autograd.Function):
    """F.conv2d(x, weight, stride=2, padding=1) whose input gradient, a
    transposed convolution of the output gradient, is conv_transpose_k4s2;
    the weight gradient is cuDNN's, as autograd's."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, stride=2, padding=1)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        wants_x, wants_weight = ctx.needs_input_grad
        return (conv_transpose_k4s2(grad, weight) if wants_x else None,
                _weight_grad(grad, x, weight, False) if wants_weight else None)


class _ConvTransposeK4S2(torch.autograd.Function):
    """conv_transpose_k4s2 with autograd's backward of
    F.conv_transpose2d(x, weight, stride=2, padding=1): the input gradient
    a forward convolution, the weight gradient cuDNN's."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv_transpose_k4s2(x, weight)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        wants_x, wants_weight = ctx.needs_input_grad
        return (F.conv2d(grad, weight, stride=2, padding=1) if wants_x else None,
                _weight_grad(grad, x, weight, True) if wants_weight else None)


class InstanceNorm(nn.Module):
    """Per-(sample, channel) normalization over H, W with learned scale and
    offset (networks.py:147-180). In bfloat16 the elementwise passes stay
    bfloat16 and the statistics accumulate in float32 by the single-pass
    E[x^2] - E[x]^2 form, as the JAX package does."""

    def __init__(self, features: int, eps: float = INSTANCE_NORM_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.offset = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        gamma = self.scale.view(1, -1, 1, 1)
        beta = self.offset.view(1, -1, 1, 1)
        if x.dtype == torch.bfloat16:
            mean = x.mean((2, 3), keepdim=True, dtype=torch.float32)
            mean2 = torch.square(x).mean((2, 3), keepdim=True, dtype=torch.float32)
            var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
            inv = torch.rsqrt(var + self.eps)
            scale = (gamma * inv).to(x.dtype)
            offset = (beta - mean * gamma * inv).to(x.dtype)
            return x * scale + offset
        x32 = x.float()
        mean = x32.mean((2, 3), keepdim=True)
        var = x32.var((2, 3), keepdim=True, unbiased=False)
        normed = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (normed * gamma + beta).to(x.dtype)


class DownBlock(nn.Module):
    """Conv k4 s2 SAME (pad 1 each side) -> [InstanceNorm] -> LeakyReLU."""

    def __init__(self, in_channels: int, filters: int, apply_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(filters, in_channels, 4, 4))
        self.norm = InstanceNorm(filters) if apply_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _ConvK4S2.apply(x.to(self.dtype), self.weight.to(self.dtype))
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, LEAKY_RELU_SLOPE)


class UpBlock(nn.Module):
    """Transposed conv k4 s2 SAME -> InstanceNorm -> [Dropout 0.5] -> ReLU.

    The weight is PyTorch's (in, out, kh, kw). flax's
    ConvTranspose(transpose_kernel=False) kernel K (kh, kw, in, out) computes
    the same function as this weight = K[::-1, ::-1].transpose(2, 3, 0, 1)
    with padding 1 (models/convert.py; pinned in tests)."""

    def __init__(self, in_channels: int, filters: int, apply_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.apply_dropout = apply_dropout
        self.weight = nn.Parameter(torch.empty(in_channels, filters, 4, 4))
        self.norm = InstanceNorm(filters)

    def forward(self, x, generator: torch.Generator | DropoutDraw | None = None,
                deterministic: bool = False) -> torch.Tensor:
        x = channels_last(x.to(self.dtype))
        conv_transpose_layouts["channels_last" if x.stride() == _nhwc_strides(x.shape)
                               else "other"] += 1
        x = _ConvTransposeK4S2.apply(x, self.weight.to(self.dtype))
        x = self.norm(x)
        if self.apply_dropout and not deterministic:
            if generator is None:
                raise ValueError("dropout needs an explicit torch.Generator or DropoutDraw")
            if isinstance(generator, torch.Generator):
                generator = DropoutDraw(generator)
            # flax nn.Dropout: keep with probability 1 - rate, scale by 1/keep;
            # the mask is drawn (B, C, H, W) contiguous and then laid out like x,
            # since an elementwise op that mixes layouts writes NCHW
            keep = channels_last(generator.keep_mask(x.shape, x.device))
            x = torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))
        return F.relu(x)


class HeadConv(nn.Module):
    """Conv k4 s1 SAME with bias. SAME pads a k4 window asymmetrically,
    1 before and 2 after each spatial axis (HEAD_PAD), hence the explicit
    F.pad; `conv_padded` takes an input padded already."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 4, 4))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_padded(F.pad(x.to(self.dtype), HEAD_PAD))

    def conv_padded(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype))


class _HeadInput(torch.autograd.Function):
    """cat([x, skip], channels) padded by HEAD_PAD, written into one NCHW
    buffer: the one copy that the concatenation and the pad made anyway
    also turns the NHWC decoder's output into the head's NCHW input.
    Backward hands both gradients back NHWC, one copy each, so that the
    decoder's backward does not run on NCHW gradients."""

    @staticmethod
    def forward(ctx, x, skip):
        b, c, h, w = x.shape
        left, right, top, bottom = HEAD_PAD
        out = x.new_zeros((b, c + skip.shape[1], top + h + bottom, left + w + right))
        out[:, :c, top:top + h, left:left + w] = x
        out[:, c:, top:top + h, left:left + w] = skip
        ctx.channels, ctx.size = c, (h, w)
        return out

    @staticmethod
    def backward(ctx, grad):
        left, _, top, _ = HEAD_PAD
        h, w = ctx.size
        inner = grad[:, :, top:top + h, left:left + w]
        wants_x, wants_skip = ctx.needs_input_grad
        return (channels_last(inner[:, :ctx.channels]) if wants_x else None,
                channels_last(inner[:, ctx.channels:]) if wants_skip else None)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialization: conv kernels N(0, 0.02), biases
    and norm offsets 0, norm scales 1; kernels drawn from `generator`."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":
                p.normal_(0.0, CONV_INIT_STD, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            else:  # bias, offset
                p.zero_()


class UnetGenerator(nn.Module):
    """6-down/6-up U-Net with the raw input as the last skip."""

    def __init__(
        self,
        input_channels: int = 4,
        output_channels: int = 4,
        last_activation: str = "tanh",
        dtype: torch.dtype = torch.float32,
        down_filters: Sequence[int] = (64, 128, 256, 512, 512, 512),
        up_filters: Sequence[int] = (512, 512, 256, 128, 64, 32),
    ):
        super().__init__()
        if last_activation not in ("tanh", "softmax", "linear"):
            raise ValueError(f"unknown activation {last_activation!r}")
        self.last_activation = last_activation
        self.down = nn.ModuleList()
        cin = input_channels
        for i, f in enumerate(down_filters):
            self.down.append(DownBlock(cin, f, apply_norm=i != 0, dtype=dtype))
            cin = f
        skip_widths = list(reversed(down_filters[:-1])) + [input_channels]
        self.up = nn.ModuleList()
        for i, f in enumerate(up_filters):
            self.up.append(UpBlock(cin, f, apply_dropout=i < 3, dtype=dtype))
            cin = f + skip_widths[i]
        self.head = HeadConv(cin, output_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | DropoutDraw | None = None,
                deterministic: bool = False, logits: bool = False) -> torch.Tensor:
        """(B, 64, 64, C) NHWC -> (B, 64, 64, out) NHWC: float32 after tanh
        or softmax; the head's output in the compute dtype under "linear"
        or with `logits` (the softmax head's logits, which the indexed step
        and generate take: argmax and the log-space losses need no
        probabilities)."""
        x = _nchw(x)
        inputs = x
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
        skip_sources = list(reversed(skips[:-1])) + [inputs]
        x = self.up[0](x, generator, deterministic)
        for block, skip in zip(self.up[1:], skip_sources):
            x = block(torch.cat([x, skip.to(x.dtype)], dim=1), generator, deterministic)
        x = self.head.conv_padded(_HeadInput.apply(x, skip_sources[-1].to(x.dtype)))
        if logits or self.last_activation == "linear":
            return _nhwc(x)
        if self.last_activation == "tanh":
            return _nhwc(torch.tanh(x.float()))
        return _nhwc(torch.softmax(x.float(), dim=1))


class PatchDiscriminator(nn.Module):
    """Shallow PatchGAN: (B, 64, 64, C) pair -> (B, 32, 32, 1) float32 logits."""

    def __init__(self, input_channels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.down = DownBlock(2 * input_channels, 64, apply_norm=False, dtype=dtype)
        self.head = HeadConv(64, 1, dtype=dtype)

    def forward(self, target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        # concat order is [target, source] (reference networks.py:45)
        x = torch.cat([target.to(self.dtype), source.to(self.dtype)], dim=-1)
        return _nhwc(self.head(self.down(_nchw(x))).float())


def build_generator(config, dtype: torch.dtype) -> UnetGenerator:
    return UnetGenerator(
        input_channels=config.generator_in_channels,
        output_channels=config.generator_out_channels,
        last_activation=config.generator_last_activation,
        dtype=dtype,
        down_filters=tuple(config.down_filters),
        up_filters=tuple(config.up_filters),
    )


def build_discriminator(config, dtype: torch.dtype) -> PatchDiscriminator:
    return PatchDiscriminator(input_channels=config.discriminator_in_channels, dtype=dtype)
