"""The PyTorch port's palette ops and kernel K5's plain version against the
JAX package's.

* pack/unpack, and `extract_palette` under "top2bottom", "bottom2top" and
  "grayness" against the TF-computed `palette.npz` (an 8x8 image: fewer
  pixels than palette slots, so the n < 256 pad) and against the JAX
  function on pairs with few colours, more than 256 colours (truncation),
  colours equal in RGB and different in alpha (exact luma ties, which only
  a stable sort keeps in appearance order) and a tiny image; exact;
* "shuffled" by its property (the port draws from a torch.Generator, the
  JAX package from jax.random, so the permutations differ): the valid
  colours permuted, the fillers last, the same generator seed the same
  palette;
* `rgba_to_indexed`'s plain version (the CPU path of kernel K5) against
  `indexed.npz`, the JAX XLA function and the JAX kernel K5 in interpret
  mode, exact, with hotpink pixels whose labels sum past 255;
* `indexed_to_rgba` clamping those labels as JAX's gather does;
* the K5 wrapper refusing what the kernel does not take.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from palette_and_histo_gan_tpu.ops import palette as jp
from palette_and_histo_gan_tpu.ops import palette_pallas as jpp
from palette_and_histo_gan_tpu_torch.config import INVALID_INDEX_COLOR, MAX_PALETTE_SIZE
from palette_and_histo_gan_tpu_torch.ops import palette as tp
from palette_and_histo_gan_tpu_torch.ops import palette_kernel as pk
from palette_and_histo_gan_tpu_torch.ops import palette_pallas as tpp

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ORDERINGS = ("top2bottom", "bottom2top", "grayness")
HOTPINK = np.array(INVALID_INDEX_COLOR, np.uint8)


def _pair(case: str, seed: int):
    """A uint8 (H, W, 4) source/target pair of one kind."""
    rng = np.random.default_rng(seed)
    if case == "over256":
        return (rng.integers(0, 256, (64, 64, 4), dtype=np.uint8),
                rng.integers(0, 256, (64, 64, 4), dtype=np.uint8))
    size = 4 if case == "tiny" else 64
    pool = rng.integers(0, 256, (12, 4), dtype=np.uint8)
    if case == "alpha_ties":
        pool[1::2, :3] = pool[0::2, :3]  # same RGB, another alpha: equal luma
        pool[1::2, 3] = 255 - pool[0::2, 3]
    pool[3] = HOTPINK
    return tuple(pool[rng.integers(0, 12, (size, size))] for _ in range(2))


def test_pack_unpack_match_jax():
    colors = np.random.default_rng(0).integers(0, 256, (100, 4), dtype=np.int32)
    packed = tp.pack_rgba(torch.from_numpy(colors))
    assert packed.dtype == torch.int64
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jp.pack_rgba(jnp.asarray(colors))).astype(np.int64)
    )
    np.testing.assert_array_equal(tp.unpack_rgba(packed).numpy(), colors)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_extract_palette_matches_tf_unique(ordering):
    g = np.load(os.path.join(GOLDEN, "palette.npz"))
    out = tp.extract_palette(torch.from_numpy(g["image"]), ordering)
    assert out.dtype == torch.int32 and out.shape == (MAX_PALETTE_SIZE, 4)
    np.testing.assert_array_equal(out.numpy(), g[ordering])


@pytest.mark.parametrize("case", ["few", "over256", "alpha_ties", "tiny"])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_joint_palette_matches_jax(ordering, case):
    """The interleaved (H, W, 8) reshape, the pad, the truncation and the
    stable luma sort, against the JAX function, exact; the batched form
    equals the per-pair one."""
    pairs = [_pair(case, seed) for seed in range(3)]
    want = [
        np.asarray(jp.joint_palette_for_pair(jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32),
                                             ordering))
        for s, t in pairs
    ]
    src = torch.from_numpy(np.stack([s for s, _ in pairs]))
    tgt = torch.from_numpy(np.stack([t for _, t in pairs]))
    batched = tp.joint_palettes(src, tgt, ordering)
    for i, (s, t) in enumerate(pairs):
        np.testing.assert_array_equal(batched[i].numpy(), want[i])
        one = tp.joint_palette_for_pair(torch.from_numpy(s), torch.from_numpy(t), ordering)
        np.testing.assert_array_equal(one.numpy(), want[i])
    if case == "over256":
        assert not np.any(np.all(want[0] == HOTPINK, -1))  # every slot a colour


def test_grayness_ties_keep_appearance_order():
    """Two colours of one RGB and another alpha have the same luma; the
    stable sort keeps them in order of first appearance."""
    a, b = [10, 20, 30, 255], [10, 20, 30, 7]
    darker = [1, 1, 1, 255]
    img = torch.tensor([[b, a], [darker, a]], dtype=torch.int32)
    out = tp.extract_palette(img, "grayness")
    np.testing.assert_array_equal(out[:3].numpy(), [darker, b, a])
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jp.extract_palette(jnp.asarray(img.numpy()), "grayness"))
    )


def test_shuffled_permutes_the_valid_colours():
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 200, (12, 4), dtype=np.uint8)  # no hotpink among them
    src, tgt = (torch.from_numpy(pool[rng.integers(0, 12, (1, 64, 64))]) for _ in range(2))
    base = tp.joint_palettes(src, tgt, "top2bottom")[0].numpy()
    n = int(np.sum(~np.all(base == HOTPINK, -1)))
    assert n == 12

    def shuffled(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return tp.joint_palettes(src, tgt, "shuffled", gen)[0].numpy()

    first = shuffled(1)
    # the valid colours, in another order; the fillers last
    assert sorted(map(tuple, first[:n])) == sorted(map(tuple, base[:n]))
    assert not np.array_equal(first[:n], base[:n])
    np.testing.assert_array_equal(first[n:], base[n:])
    np.testing.assert_array_equal(shuffled(1), first)
    assert not np.array_equal(shuffled(2), first)
    with pytest.raises(ValueError, match="torch.Generator"):
        tp.joint_palettes(src, tgt, "shuffled")


def test_rgba_to_indexed_matches_reference_semantics():
    g = np.load(os.path.join(GOLDEN, "indexed.npz"))
    out = tp.rgba_to_indexed(torch.from_numpy(g["image"]), torch.from_numpy(g["palette"]))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), g["expected"])


@pytest.mark.parametrize("ordering", ["grayness", "bottom2top"])
def test_plain_k5_matches_jax_xla_and_pallas_k5(ordering):
    """Few-colour pairs with hotpink pixels (labels past 255), a truncated
    pair and a palette that matches nothing, against JAX's XLA function and
    JAX's K5 in interpret mode: exact."""
    pairs = [_pair("few", 7), _pair("over256", 8), _pair("alpha_ties", 9)]
    src = np.stack([s for s, _ in pairs])
    tgt = np.stack([t for _, t in pairs])
    pal = tp.joint_palettes(torch.from_numpy(src), torch.from_numpy(tgt), ordering)
    pal[2] = 99  # no pixel matches: every label 0
    got = pk.rgba_to_indexed_plain(torch.from_numpy(src), pal)
    xla = np.stack([
        np.asarray(jp.rgba_to_indexed(jnp.asarray(s, jnp.int32), jnp.asarray(p.numpy())))
        for s, p in zip(src, pal)
    ])
    with pltpu.force_tpu_interpret_mode():
        k5 = np.asarray(jpp.rgba_to_indexed_pallas_batch(jnp.asarray(src, jnp.int32),
                                                         jnp.asarray(pal.numpy())))
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), k5)
    assert got.shape == (3, 64, 64, 1) and got.dtype == torch.int32
    assert int(got[0].max()) > 255  # hotpink matches its slot and every filler
    assert int(got[2].max()) == 0
    # the single-image and batched entry points are the same function
    np.testing.assert_array_equal(
        tpp.rgba_to_indexed_pallas(torch.from_numpy(src[0]), pal[0]).numpy(), xla[0]
    )
    np.testing.assert_array_equal(
        tpp.rgba_to_indexed_pallas_batch(torch.from_numpy(src), pal).numpy(), xla
    )
    np.testing.assert_array_equal(tp.rgba_to_indexed(torch.from_numpy(src), pal).numpy(), xla)


def test_indexed_to_rgba_clamps_labels_past_255():
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (2, 256, 4), dtype=np.int32)
    idx = rng.integers(0, 256, (2, 8, 8, 1), dtype=np.int32)
    idx[0, 0, 0, 0] = 300
    idx[1, 5, 5, 0] = 32157
    got = tp.indexed_to_rgba(torch.from_numpy(idx), torch.from_numpy(pal))
    want = np.stack([
        np.asarray(jp.indexed_to_rgba(jnp.asarray(i), jnp.asarray(p))) for i, p in zip(idx, pal)
    ])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0, 0].numpy(), pal[0, 255])
    single = tp.indexed_to_rgba(torch.from_numpy(idx[1]), torch.from_numpy(pal[1]))
    np.testing.assert_array_equal(single.numpy(), want[1])


def test_index_then_decode_round_trips():
    s, t = _pair("few", 11)
    s[s[..., 3:4].repeat(4, -1) == 0] = 0
    src = torch.from_numpy(s)[None]
    pal = tp.joint_palettes(src, torch.from_numpy(t)[None], "grayness")
    back = tp.indexed_to_rgba(tp.rgba_to_indexed(src, pal), pal)
    hot = np.all(s == HOTPINK, -1)
    # every pixel decodes to itself, but hotpink ones, whose label sums past
    # 255 and clamps to the last slot, itself a hotpink filler
    np.testing.assert_array_equal(back[0].numpy()[~hot], s[~hot])
    np.testing.assert_array_equal(back[0].numpy()[hot], np.broadcast_to(HOTPINK, (hot.sum(), 4)))


def test_k5_wrapper_checks_its_inputs():
    images = torch.zeros((2, 8, 8, 4), dtype=torch.uint8)
    palettes = torch.zeros((2, 256, 4), dtype=torch.int32)
    pk.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        pk.rgba_to_indexed_cuda(images, palettes)
    with pytest.raises(ValueError, match="uint8"):
        pk.rgba_to_indexed_plain(images.int(), palettes)
    with pytest.raises(ValueError, match="int32"):
        pk.rgba_to_indexed_plain(images, palettes[:1])
    with pytest.raises(ValueError, match="contiguous"):
        pk.rgba_to_indexed_plain(images.transpose(1, 2), palettes)
    assert pk.rgba_to_indexed(images, palettes).shape == (2, 8, 8, 1)
    assert pk.launches == {"K5": 0}  # the CPU path launches nothing
