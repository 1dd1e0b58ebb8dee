"""Differentiable RGB-uv color histogram and the histogram losses.

Mirrors palette_and_histo_gan_tpu/ops/histogram.py, whose default path is
XLA code and not a TPU kernel, so this is plain PyTorch:
  * the forward is `_unnormalized_histograms` (:77-96);
  * the backward is the hand-structured "tri" VJP (`_histogram_core_bwd`,
    :143-185): per channel three products, each consumed by one
    elementwise-and-reduce chain; `bwd="pallas"` swaps in kernel K4c
    (ops/histogram_pallas3.py), as JAX's `_histogram_core_pallas_bwd`;
  * `hellinger_loss` and `l1_loss` (:517-530); the Hellinger loss also
    over the ranks of a data-parallel group.

Formulas (image in [-1, 1], rescaled to [0, 1], alpha dropped):
  Iy = sqrt(R^2 + G^2 + B^2 + eps)
  Iu = log(c + eps) - log(p1 + eps),  Iv = log(c + eps) - log(p2 + eps)
  k(d) = 1 / (1 + d^2 / sigma^2)  ("inverse-quadratic")  or  exp(-d^2 / sigma^2)
  H_c = (Iy * Ku)^T @ Kv over 64 bins on linspace(-3, 3), normalized to sum 1.

`dtype` is the precision of the (B, HW, size) kernel chain: float32 gives
exact float32 products (the caller turns TF32 off, see config.py); bfloat16
runs the chain in bfloat16 with float32 accumulation and float32 results.
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-6

# channel -> (component, projection1, projection2): R uses (r, g, b),
# G uses (g, r, b), B uses (b, r, g)
CHANNEL_TRIPLES = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with a float32 result. bfloat16 operands accumulate in
    float32: on the card through the tensor cores, on the CPU by multiplying
    their exact float32 values."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _kernel(x: torch.Tensor, method: str, sigma_sqr: float) -> torch.Tensor:
    d = torch.square(x) / sigma_sqr
    if method == "RBF":
        return torch.exp(-d)
    if method == "inverse-quadratic":
        return 1.0 / (1.0 + d)
    raise ValueError(f"unknown histogram method {method!r}")


def _kernel_and_slope(diff, domain, method, sigma_sqr, dtype):
    """K(diff - t) and dK/d(diff), both (B, HW, size) in `dtype`."""
    x = diff[..., None].to(dtype) - domain
    k = _kernel(x, method, sigma_sqr)
    kp = -k if method == "RBF" else -k * k
    return k, kp * (2.0 / sigma_sqr) * x


def _domain(size, dtype, device):
    # bin centres rounded once from float64, like jnp.linspace's float32 values
    domain = torch.linspace(-3.0, 3.0, size, dtype=torch.float64, device=device)
    return domain.to(torch.float32).to(dtype)[None, :]


def unnormalized_histograms(flat01, size, method, sigma, dtype):
    """(B, HW, 3) pixels in [0, 1] -> stacked unnormalized (B, size, size, 3)."""
    sigma_sqr = sigma**2
    domain = _domain(size, dtype, flat01.device)
    intensities = torch.sqrt(
        torch.square(flat01[..., 0])
        + torch.square(flat01[..., 1])
        + torch.square(flat01[..., 2])
        + EPSILON
    )[..., None].to(dtype)
    logs = torch.log(flat01 + EPSILON)
    planes = []
    for c, p1, p2 in CHANNEL_TRIPLES:
        iu = (logs[..., c] - logs[..., p1])[..., None].to(dtype)
        iv = (logs[..., c] - logs[..., p2])[..., None].to(dtype)
        ku = _kernel(iu - domain, method, sigma_sqr).to(dtype)
        kv = _kernel(iv - domain, method, sigma_sqr).to(dtype)
        a = (intensities * ku).transpose(1, 2)  # (B, size, HW)
        planes.append(matmul_f32(a, kv))
    return torch.stack(planes, dim=-1)


class _HistogramCore(torch.autograd.Function):
    """Unnormalized histograms with the "tri" backward."""

    @staticmethod
    def forward(ctx, flat01, size, method, sigma, dtype):
        ctx.save_for_backward(flat01)
        ctx.args = (size, method, sigma, dtype)
        return unnormalized_histograms(flat01, size, method, sigma, dtype)

    @staticmethod
    def backward(ctx, g):
        (flat01,) = ctx.saved_tensors
        size, method, sigma, dtype = ctx.args
        sigma_sqr = sigma**2
        domain = _domain(size, dtype, flat01.device)
        iy32 = torch.sqrt(torch.sum(torch.square(flat01), dim=-1) + EPSILON)
        iy = iy32[..., None].to(dtype)
        logs = torch.log(flat01 + EPSILON)
        g = g.to(dtype)

        def mm(a, b):
            return torch.matmul(a, b) if dtype == torch.float32 else matmul_f32(a, b).to(dtype)

        d_log = [0.0, 0.0, 0.0]
        d_iy = 0.0
        for ch, (c, p1, p2) in enumerate(CHANNEL_TRIPLES):
            iu = logs[..., c] - logs[..., p1]
            iv = logs[..., c] - logs[..., p2]
            ku, su = _kernel_and_slope(iu, domain, method, sigma_sqr, dtype)
            kv, sv = _kernel_and_slope(iv, domain, method, sigma_sqr, dtype)
            gc = g[..., ch]  # (B, size, size): rows are u-bins, columns v-bins
            m1 = mm(ku, gc)  # iy chain
            da = mm(kv, gc.transpose(1, 2))  # iu chain
            dkv = mm(iy * ku, gc)  # iv chain
            s_y = torch.sum(m1 * kv, dim=-1, dtype=torch.float32)
            s_u = torch.sum(da * su, dim=-1, dtype=torch.float32)
            s_v = torch.sum(dkv * sv, dim=-1, dtype=torch.float32)
            d_iu = iy32 * s_u
            d_iy = d_iy + s_y
            d_log[c] = d_log[c] + (d_iu + s_v)
            d_log[p1] = d_log[p1] - d_iu
            d_log[p2] = d_log[p2] - s_v
        d_flat = (
            torch.stack(d_log, dim=-1) / (flat01 + EPSILON)
            + (d_iy / iy32)[..., None] * flat01
        )
        return d_flat, None, None, None, None


def calculate_rgbuv_histogram(
    image_batch: torch.Tensor,
    size: int = 64,
    method: str = "inverse-quadratic",
    sigma: float = 0.02,
    dtype: torch.dtype = torch.float32,
    bwd: str = "tri",
) -> torch.Tensor:
    """Differentiable color histogram of a [-1, 1] NHWC batch, (B, size,
    size, 3), normalized to sum 1 per image. `bwd` is the backward: "tri"
    (plain PyTorch) or "pallas" (kernel K4c); the JAX package's other
    dot structures ("dual", "tri2", "tri2b", "tri2c") are not ported."""
    if bwd == "tri":
        core = _HistogramCore
    elif bwd == "pallas":
        from .histogram_pallas3 import HistogramCorePallasBwd as core
    else:
        raise ValueError(f"histogram bwd {bwd!r}: the port has 'tri' and 'pallas'")
    image_batch = image_batch * 0.5 + 0.5
    flat = image_batch[..., :3].reshape(image_batch.shape[0], -1, 3)
    histograms = core.apply(flat, size, method, sigma, dtype)
    return histograms / torch.sum(histograms, dim=(1, 2, 3), keepdim=True)


def hellinger_loss(y_true: torch.Tensor, y_pred: torch.Tensor, group=None) -> torch.Tensor:
    """(1/sqrt(2)) * ||sqrt(H_pred) - sqrt(H_true)||_2 / B.

    One norm over the whole batch, not a mean of per-image terms. Under
    data parallelism (`group`, a parallel.mesh.DataGroup, each rank holding
    its rows) the sum of squares is summed over the ranks before the root
    and B is the global batch, so every rank holds one process's value; a
    rank's own norm over its B/N rows would read about sqrt(N) times it.
    The sum's backward hands each rank N times the cotangent, so that the
    gradients' mean over the ranks is one process's (parallel/mesh.py)."""
    squares = torch.sum(torch.square(torch.sqrt(y_pred) - torch.sqrt(y_true)))
    batch = y_true.shape[0]
    if group is not None:
        squares = group.sum_across(squares)
        batch *= group.world_size
    return torch.sqrt(squares) / math.sqrt(2.0) / batch


def l1_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.mean(torch.abs(y_true - y_pred))
