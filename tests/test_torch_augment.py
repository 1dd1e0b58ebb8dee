"""The PyTorch port's augmentation against the JAX package's.

The port's plain version (palette_and_histo_gan_tpu_torch/ops/augment.py,
the CPU counterpart of the CUDA kernel csrc/augment.cu) is held against the
TPU kernels K1 (`_augment_kernel_packed`) and K2 (`_augment_kernel`), run
in Pallas interpret mode on the CPU, on the same numpy draws, and against
the TF-computed golden fixtures. The CUDA kernel itself is compared with
the plain version on the card by chip_smoke.py.

Tolerances: 5e-4 on the 0-255 scale for float32 output (the tolerance of
augment_pallas.py:67-68; 5e-4 / 127.5 after the fused normalize), and one
bfloat16 ulp (relative 2^-7) for bfloat16 output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu.ops import augment_pallas as ap
from palette_and_histo_gan_tpu_torch.ops import augment as ta
from palette_and_histo_gan_tpu_torch.ops import augment_kernel

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B = 8
F32_TOL = 5e-4  # on the 0-255 scale
BF16_RTOL = 2.0**-7  # one bfloat16 ulp


def _draws(seed=3, b=B):
    rng = np.random.default_rng(seed)
    delta = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    sy = rng.integers(-10, 6, b).astype(np.int32)
    sx = rng.integers(-8, 9, b).astype(np.int32)
    keep = np.array([1, 0] * (b // 2), np.int32)  # both branches
    return delta, sy, sx, keep


def _images(seed=5, b=B):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, (b, 64, 64, 4), dtype=np.uint8),
        rng.integers(0, 256, (b, 64, 64, 4), dtype=np.uint8),
    )


def _jax_kernel(fmt, src, tgt, draws, normalize_out, out_dtype):
    b = src.shape[0]
    if fmt == "packed":
        s, t = (
            jax.lax.bitcast_convert_type(jnp.asarray(x).reshape(b, -1, 4), jnp.uint32)
            .reshape(b, 64, 64)
            for x in (src, tgt)
        )
        out = ap._call_kernel_packed(
            *draws, s, t, normalize_out=normalize_out, out_dtype=out_dtype
        )
    else:
        dtype = jnp.uint8 if fmt == "u8" else jnp.float32
        s, t = (jnp.asarray(x, dtype).reshape(b, 64, 256) for x in (src, tgt))
        out = ap._call_kernel(*draws, s, t, normalize_out=normalize_out, out_dtype=out_dtype)
    return [np.asarray(o.astype(jnp.float32)).reshape(b, 64, 64, 4) for o in out]


def _torch_input(fmt, x):
    t = torch.from_numpy(x)
    if fmt == "packed":
        return t.view(x.shape[0], -1).view(torch.int32)
    return t if fmt == "u8" else t.float()


@pytest.mark.parametrize("fmt", ["packed", "u8", "f32"])
@pytest.mark.parametrize(
    "normalize_out,out_dtype",
    [(False, "float32"), (True, "float32"), (True, "bfloat16")],
)
def test_plain_matches_tpu_kernel(fmt, normalize_out, out_dtype):
    src, tgt = _images()
    draws = _draws()
    ref = _jax_kernel(fmt, src, tgt, draws, normalize_out, jnp.dtype(out_dtype))
    tdraws = [torch.from_numpy(d) for d in draws]
    out = ta.augment_plain(
        _torch_input(fmt, src), _torch_input(fmt, tgt), *tdraws,
        normalize_out=normalize_out, out_dtype=getattr(torch, out_dtype),
    )
    for o, r in zip(out, ref):
        o = o.float().numpy()
        if out_dtype == "bfloat16":
            np.testing.assert_allclose(o, r, rtol=BF16_RTOL, atol=F32_TOL / 127.5)
        else:
            scale = 127.5 if normalize_out else 1.0
            np.testing.assert_allclose(o, r, atol=F32_TOL / scale, rtol=0)


def test_kept_and_passed_pairs():
    """keep == 0 passes the pair through exactly; keep == 1 moves pixels."""
    src, tgt = _images(7)
    delta, sy, sx, keep = _draws(9)
    sy[:] = 3
    out_s, _ = ta.augment_plain(
        torch.from_numpy(src), torch.from_numpy(tgt),
        *(torch.from_numpy(d) for d in (delta, sy, sx, keep)),
    )
    np.testing.assert_array_equal(out_s[1].numpy(), src[1].astype(np.float32))
    # rows shifted in from outside are zero fill
    assert float(out_s[0, :3].abs().sum()) == 0.0


def test_draw_distributions():
    g = torch.Generator()
    g.manual_seed(0)
    delta, sy, sx, keep = ta.draw_params(g, 20000, 0.8)
    assert delta.dtype == torch.float32 and sy.dtype == torch.int32
    assert keep.dtype == torch.int32
    assert -0.5 <= float(delta.min()) and float(delta.max()) < 0.5
    # round(U(-0.15, 0.075) * 64) and round(U(-0.125, 0.125) * 64)
    assert int(sy.min()) == -10 and int(sy.max()) == 5
    assert int(sx.min()) == -8 and int(sx.max()) == 8
    assert abs(float(keep.float().mean()) - 0.8) < 0.02


def test_cpu_batch_takes_plain_version():
    src, tgt = _images(11, 4)
    draws = [torch.from_numpy(d) for d in _draws(13, 4)]
    before = dict(augment_kernel.launches)
    s, t = (torch.from_numpy(x) for x in (src, tgt))
    out = ta.augment_with_draws(s, t, *draws, normalize_out=True)
    ref = ta.augment_plain(s, t, *draws, normalize_out=True)
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)
    assert augment_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_and_bad_inputs():
    s = torch.zeros(2, 64, 64, 4, dtype=torch.uint8)
    draws = (
        torch.zeros(2), torch.zeros(2, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
    )
    with pytest.raises(ValueError, match="CUDA"):
        augment_kernel.augment_cuda(s, s, *draws)
    with pytest.raises(ValueError, match="augment kernel takes"):
        augment_kernel.input_format(torch.zeros(2, 64, 64, 3))
    assert augment_kernel.input_format(s.view(2, -1).view(torch.int32)) == augment_kernel.FMT_PACKED


def _golden(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def test_hsv_matches_tf_golden():
    g = _golden("hsv")
    rgb = torch.from_numpy(g["rgb"])
    h, vmax, _, rng = ta.hue_sextant(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    s = torch.where(vmax == 0, torch.zeros_like(rng), rng / vmax)
    hsv = torch.stack([h / 6.0, s, vmax], dim=-1).numpy()
    np.testing.assert_allclose(hsv, g["hsv"], rtol=1e-4, atol=1e-3)


def test_hue_rotation_matches_tf_golden():
    g = _golden("hue")
    for img, d, expected in zip(g["images"], g["deltas"], g["expected"]):
        x = torch.from_numpy(img)
        out = torch.stack(ta.hue_rotate(x[..., 0], x[..., 1], x[..., 2], float(d)), -1)
        np.testing.assert_allclose(out.numpy(), expected, rtol=1e-3, atol=0.51)


def test_translation_matches_tf_golden():
    g = _golden("translate")
    offsets = np.round(g["offsets"]).astype(np.int32)  # no .5 ties in the fixture
    out = ta.shift_images(
        torch.from_numpy(g["images"]),
        torch.from_numpy(offsets[:, 0]), torch.from_numpy(offsets[:, 1]),
    )
    np.testing.assert_allclose(out.numpy(), g["expected"], atol=1e-4)
