"""The indexed losses' kernel pair (`ops/indexed_loss.py`,
`csrc/indexed_loss.cu`) on the CPU.

* `indexed_losses` on CPU logits is the two functions of
  `train/losses.py` bit for bit, values and gradients, under any upstream
  gradients (the step's L1 weight is 0; here it is not);
* against the JAX package's `sparse_categorical_crossentropy_logits` and
  `onehot_l1_logits` at float32 and bfloat16, labels past 255 included;
* the kernels' arithmetic, written out in PyTorch as the CUDA source takes
  it (one lse a row, the gradient k (p_j - d_jt)), against autograd through
  the plain version: labels past 255 and below 0, a nonzero L1 gradient,
  and a row whose lse - z_t sits at each clip bound (the bound moved onto
  the row; a clamp passes the gradient at its bounds) and one a float32
  step outside;
* a CUDA tensor reaching the kernels' wrapper, never the plain version; the
  layout the kernels take (the pixels of a class contiguous: the generator's
  view of NCHW memory) and the refusals of everything else, channels-last
  logits included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu.train import losses as jl
from palette_and_histo_gan_tpu_torch.ops import indexed_loss as il
from palette_and_histo_gan_tpu_torch.train import losses as tl


def _inputs(dtype, shape=(2, 8, 8), seed=9):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((*shape, 256)).astype(np.float32) * 3.0).to(dtype)
    labels = rng.integers(0, 256, shape).astype(np.int32)
    labels.reshape(-1)[:4] = (256, 300, 32157, -1)  # an all-zero one-hot row each
    return torch.from_numpy(labels), logits


def _grad(fn, labels, logits, g_seg, g_l1):
    x = logits.clone().requires_grad_(True)
    seg, l1 = fn(labels, x)
    (grad,) = torch.autograd.grad(g_seg * seg + g_l1 * l1, x)
    return seg.detach(), l1.detach(), grad


def _two_functions(labels, logits):
    l1 = tl.onehot_l1_logits(labels, logits)
    return tl.sparse_categorical_crossentropy_logits(labels, logits), l1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_seg, g_l1", [(0.01, 0.0), (1.0, 0.0), (0.5, -1.75), (0.0, 3.0)])
def test_cpu_path_is_the_two_functions_bit_for_bit(dtype, g_seg, g_l1):
    labels, logits = _inputs(dtype)
    for a, b in zip(_grad(il.indexed_losses, labels, logits, g_seg, g_l1),
                    _grad(_two_functions, labels, logits, g_seg, g_l1)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert il.launches == {"CCE-fwd": 0, "CCE-bwd": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matches_jax(dtype):
    labels, logits = _inputs(dtype)
    g_seg, g_l1 = 0.01, 0.25
    seg, l1, grad = _grad(il.indexed_losses, labels, logits, g_seg, g_l1)
    jx = jnp.asarray(logits.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jlabels = jnp.asarray(labels.numpy())

    def total(z):
        s = jl.sparse_categorical_crossentropy_logits(jlabels, z)
        l = jl.onehot_l1_logits(jlabels, z)
        return g_seg * s + g_l1 * l, (s, l)

    (_, (jseg, jl1)), jgrad = jax.value_and_grad(total, has_aux=True)(jx)
    assert seg.dtype == l1.dtype == torch.float32 and grad.dtype == dtype
    np.testing.assert_allclose(float(seg), float(jseg), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=1e-6)
    atol = 1e-7 if dtype == torch.float32 else 2e-8
    np.testing.assert_allclose(grad.float().numpy(), np.asarray(jgrad, np.float32),
                               atol=atol, rtol=1e-2 if dtype == torch.bfloat16 else 1e-5)
    assert float(grad.reshape(-1, 256)[:4].float().abs().max()) == 0.0


def kernel_arithmetic(labels, logits, g_seg, g_l1):
    """(seg, l1, grad) as csrc/indexed_loss.cu computes them, in float32:
    one lse a row, the terms summed in double
    and divided by N, the gradient k (p_j - d_jt) with
    k = g_seg m / N - valid g_l1 (-2 / C) / N p_t."""
    z = logits.detach().float().reshape(-1, 256)
    t = labels.reshape(-1).long()
    n = z.shape[0]
    valid = (t >= 0) & (t < 256)
    # torch.logsumexp takes the kernel's formula: the max (0 where
    # infinite), the shifted exponentials' sum, its log plus the max
    lse = torch.logsumexp(z, -1)
    z_t = torch.where(valid, z.gather(1, t.clamp(0, 255)[:, None])[:, 0], torch.zeros_like(lse))
    d = lse - z_t
    lo, hi = il._bounds()
    p_t = torch.exp(z_t - lse)
    seg_rows = torch.where(valid, d.clamp(lo, hi), torch.zeros_like(d))
    l1_rows = torch.where(valid, 2.0 * (1.0 - p_t), torch.ones_like(d)) / 256
    seg = (seg_rows.double().sum() / n).float()
    l1 = (l1_rows.double().sum() / n).float()
    inside = valid & (d >= lo) & (d <= hi)
    seg_scale = torch.tensor(g_seg, dtype=torch.float32) / n
    l1_scale = torch.tensor(g_l1, dtype=torch.float32) * (-2.0 / 256) / n
    k = torch.where(inside, seg_scale, 0.0) - torch.where(valid, l1_scale * p_t, 0.0)
    onehot = torch.nn.functional.one_hot(t.clamp(0, 255), 256).bool() & valid[:, None]
    p = torch.exp(z - lse[:, None])
    grad = k[:, None] * torch.where(onehot, p - 1.0, p)
    return seg, l1, grad.reshape(logits.shape).to(logits.dtype)


def _bound_rows(labels, logits):
    """Each row's lse - z_t as the plain version computes it."""
    lse = torch.logsumexp(logits.float(), -1)
    return (lse - tl._select_label(labels, logits).float()).reshape(-1)


@pytest.mark.parametrize("g_seg, g_l1", [(0.01, 0.0), (0.5, -1.75)])
@pytest.mark.parametrize("bound", ["NEG_LOG_MIN", "NEG_LOG_MAX", None])
def test_kernel_arithmetic_is_the_plain_version(monkeypatch, g_seg, g_l1, bound):
    labels, logits = _inputs(torch.float32, seed=3)
    d = _bound_rows(labels, logits)
    row = 7
    if bound is not None:
        # move the bound onto row 7's lse - z_t: the clip binds there with
        # the row's gradient still passed
        monkeypatch.setattr(tl, bound, float(d[row]))
    seg, l1, grad = _grad(il.indexed_losses_plain, labels, logits, g_seg, g_l1)
    kseg, kl1, kgrad = kernel_arithmetic(labels, logits, g_seg, g_l1)
    np.testing.assert_allclose(float(kseg), float(seg), rtol=2e-6)
    np.testing.assert_allclose(float(kl1), float(l1), rtol=2e-6)
    scale = float(grad.abs().max())
    np.testing.assert_allclose(kgrad.numpy(), grad.numpy(), atol=1e-6 * scale, rtol=1e-5)
    flat = grad.reshape(-1, 256)
    assert float(flat[:4].abs().max()) == 0.0  # labels 256, 300, 32157, -1
    assert float(flat[row].abs().max()) > 0.0
    if bound is not None:
        # one float32 step outside the bound: the clip cuts the row's
        # cross-entropy gradient
        outside = np.nextafter(np.float32(d[row]), np.float32(np.inf if bound == "NEG_LOG_MIN" else -np.inf))
        monkeypatch.setattr(tl, bound, float(outside))
        _, _, cut = _grad(il.indexed_losses_plain, labels, logits, 1.0, 0.0)
        _, _, kcut = kernel_arithmetic(labels, logits, 1.0, 0.0)
        assert float(cut.reshape(-1, 256)[row].abs().max()) == 0.0
        assert float(kcut.reshape(-1, 256)[row].abs().max()) == 0.0
        assert float(cut.abs().max()) > 0.0


class ReachedTheKernels(Exception):
    pass


def test_cuda_tensor_goes_to_the_kernels_never_to_the_plain_version(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    labels, logits = _inputs(torch.float32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        il.forward_cuda(labels, logits.movedim(-1, 1).contiguous().movedim(1, -1))
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        il.indexed_losses(labels.to("meta"), logits.to("meta"))

    with FakeTensorMode():
        cuda_labels = torch.zeros(4, 64, 64, dtype=torch.int32, device="cuda")
        one_label = torch.zeros(1, 64, 64, dtype=torch.int32, device="cuda")
        # the generator's view of its head output: NCHW memory, as the card's
        # convolution writes it
        nchw = torch.empty(4, 256, 64, 64, device="cuda").permute(0, 2, 3, 1)
        one_image = torch.empty(1, 256, 64, 64, device="cuda").permute(0, 2, 3, 1)
        channels_last = torch.empty(4, 256, 64, 64, device="cuda").to(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
    assert il.check(cuda_labels, nchw) == (4, 4096, 256 * 4096, 4096)
    assert il.check(one_label, one_image) == (1, 4096, 0, 4096)
    with pytest.raises(ValueError, match="NCHW memory"):
        il.indexed_losses(cuda_labels, channels_last)
    before = dict(il.launches)
    # no nvcc and no card here: building or launching the kernels raises
    with pytest.raises(RuntimeError):
        il.indexed_losses(cuda_labels, nchw)
    assert il.launches == before

    reached = []

    def kernels(labels, logits):
        reached.append(tuple(logits.stride()))
        raise ReachedTheKernels

    def no_plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(il, "forward_cuda", kernels)
    monkeypatch.setattr(il, "indexed_losses_plain", no_plain)
    for lab, logits in ((cuda_labels, nchw), (one_label, one_image)):
        with pytest.raises(ReachedTheKernels):
            il.indexed_losses(lab, logits)
    assert reached == [nchw.stride(), one_image.stride()]


def _ints(*shape):
    return torch.zeros(*shape, dtype=torch.int32)


def _planar(*shape):
    """(..., 256) logits of NCHW memory: the class dimension moved last."""
    return torch.zeros(shape[0], 256, *shape[1:]).movedim(1, -1)


@pytest.mark.parametrize(
    "make, message",
    [
        (lambda: (_ints(2, 4), _planar(2, 4).half()), "float32 or bfloat16"),
        (lambda: (_ints(2, 4), _planar(2, 4).double()), "float32 or bfloat16"),
        (lambda: (_ints(2, 4), torch.zeros(2, 4, 256)), "NCHW memory"),
        (lambda: (_ints(2, 4, 4), torch.zeros(2, 256, 4, 4).to(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)), "NCHW memory"),
        (lambda: (_ints(2, 4), torch.zeros(2, 4, 512)[..., ::2]), "NCHW memory"),
        (lambda: (_ints(2, 8), torch.zeros(2, 256, 16)[..., ::2].transpose(1, 2)), "NCHW memory"),
        (lambda: (_ints(2, 4), torch.zeros(2, 128, 4).transpose(1, 2)), r"\(\.\.\., 256\)"),
        (lambda: (_ints(2, 3, 4), torch.zeros(3, 256, 2, 4).permute(2, 0, 3, 1)), "merge into no"),
        (lambda: (_ints(2, 8), torch.zeros(2, 4096).as_strided((2, 8, 256), (4096, 1, 4))), "overlap"),
        (lambda: (_ints(2, 6), _planar(2, 6)), "in 4s"),
        (lambda: (_ints(2, 4), torch.zeros(2, 256, 5)[..., :4].transpose(1, 2)), "in 4s"),
        (lambda: (_ints(2, 3), _planar(2, 4)), "do not match"),
        (lambda: (torch.zeros(2, 4), _planar(2, 4)), "integers"),
        (lambda: (_ints(0, 4), _planar(0, 4)), "empty"),
    ],
)
def test_refusals(make, message):
    labels, logits = make()
    for fn in (il.forward_cuda, lambda a, b: il.backward_cuda(a, b, None, None, None)):
        with pytest.raises(ValueError, match=message):
            fn(labels, logits)


@pytest.mark.parametrize(
    "make, want",
    [
        # (images, pixels, image_stride, class_stride)
        (lambda: _planar(2, 4, 8), (2, 32, 256 * 32, 32)),
        (lambda: _planar(1, 4, 8), (1, 32, 0, 32)),
        (lambda: _planar(3, 64, 64), (3, 4096, 256 * 4096, 4096)),
        (lambda: _planar(2, 1, 8), (2, 8, 256 * 8, 8)),
        (lambda: torch.zeros(2, 260, 8)[:, :256].transpose(1, 2), (2, 8, 260 * 8, 8)),
        (lambda: torch.zeros(2, 256, 12)[..., :8].transpose(1, 2), (2, 8, 256 * 12, 12)),
        (lambda: torch.zeros(2, 256, 3, 4)[:, :, :1].permute(0, 2, 3, 1), (2, 4, 256 * 12, 12)),
    ],
)
def test_layouts(make, want):
    assert il.layout(make()) == want
