"""The arithmetic the reference's products run in.

"float32": float32 products with TF32 off in cuDNN and cuBLAS, the
reference's own precision. The others are the controls, the precision one
step below what a configuration states, which the comparison has to refuse:
  * "tf32": TF32 on, for a float32 configuration;
  * "fp8": for a bfloat16 configuration, what bfloat16 compute keeps in
    bfloat16 kept in float8 instead: every convolution's and matrix
    product's operands rounded to float8 e4m3 (sums in float32), and every
    activation (`act`: the normalized images, the outputs of the
    convolutions, norms and
    nonlinearities, the logits, the histogram's chain: its log-chroma
    differences, intensities and kernel values) rounded to
    e4m3 forward, its gradient to e5m2 backward, each tensor with its own
    scale (its absolute maximum to the format's largest value): the usual
    recipe of float8 training.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("float32", "tf32", "fp8")
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def fake_quant(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, largest = _FP8[fmt]
    scale = largest / x.detach().abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3. Backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fake_quant(g, "e5m2")


class Precision:
    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}; one of {MODES}")
        self.mode = mode

    @contextlib.contextmanager
    def scope(self):
        """cuDNN's and cuBLAS's TF32 as the mode asks, restored after."""
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision())
        tf32 = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        try:
            yield self
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
            torch.set_float32_matmul_precision(saved[2])

    def act(self, x):
        """An activation as the mode stores it."""
        return _OutputGrad.apply(_Operand.apply(x)) if self.mode == "fp8" else x

    def _in(self, x):
        return _Operand.apply(x) if self.mode == "fp8" else x

    def _out(self, y):
        return _OutputGrad.apply(y) if self.mode == "fp8" else y

    def conv2d(self, x, w, bias=None, stride=1, padding=0):
        y = F.conv2d(self._in(x), self._in(w), None, stride, padding)
        return self.act(y if bias is None else y + bias.view(1, -1, 1, 1))

    def conv_transpose2d(self, x, w, stride=2, padding=1):
        return self.act(F.conv_transpose2d(self._in(x), self._in(w), None, stride, padding))

    def bmm(self, a, b):
        return self._out(torch.bmm(self._in(a), self._in(b)))
