"""The histogram's backward, v3: `histogram_bwd="pallas"`.

Counterpart of palette_and_histo_gan_tpu/ops/histogram_pallas3.py and of
`_histogram_core_pallas_bwd` in palette_and_histo_gan_tpu/ops/histogram.py
(:438-463): the forward is the plain PyTorch `unnormalized_histograms`
(as JAX runs its XLA forward), the backward kernel K4c
(ops/histogram_kernel.py, csrc/histogram.cu) with the chain in `dtype`, an
approximate reciprocal in bfloat16 and an exact one in float32.
"""

from __future__ import annotations

import torch

from . import histogram_kernel as hk
from .histogram import unnormalized_histograms


def backward_unnormalized_pallas3(
    flat01: torch.Tensor,
    g_unnorm: torch.Tensor,
    size: int,
    method: str,
    sigma: float,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """d(loss)/d(flat01) for the unnormalized (B, size, size, 3) histogram
    stack: the kernel plus the elementwise finish. The logs and Iy are
    taken in flat01's dtype, as the TPU version takes them."""
    logs, iy = hk.logs_and_intensity(flat01)
    g_cm = g_unnorm.float().movedim(-1, 1).contiguous()  # (B, 3, size, size)
    rows = hk.histogram_backward(
        logs.float(), iy.float(), g_cm, size=size, method=method, sigma=sigma,
        chain=dtype, approx=dtype == torch.bfloat16, kernel="K4c",
    )
    return hk.finish(rows, flat01, iy)


class HistogramCorePallasBwd(torch.autograd.Function):
    """Unnormalized histograms, plain forward, K4c backward."""

    @staticmethod
    def forward(ctx, flat01, size, method, sigma, dtype):
        ctx.save_for_backward(flat01)
        ctx.args = (size, method, sigma, dtype)
        return unnormalized_histograms(flat01, size, method, sigma, dtype)

    @staticmethod
    def backward(ctx, g):
        (flat01,) = ctx.saved_tensors
        return backward_unnormalized_pallas3(flat01, g, *ctx.args), None, None, None, None
