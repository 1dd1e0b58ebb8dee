"""The PyTorch port's networks and weight bridge against the JAX package's.

* the two layout facts the bridge rests on: flax's k4 s2 SAME transposed
  conv is PyTorch's with a flipped, transposed kernel and padding 1, and
  the k4 s1 SAME head pads 1 before and 2 after;
* the bridge (Flax tree -> state_dict) round trip, and its refusal of
  missing or unused weights;
* narrow G and D forwards against the Flax modules on bridged weights
  (float32, atol 1e-5: same convolutions, summation order aside);
* the full-width forward against the TF-computed golden fixture
  networks_rgba.npz through tests/parity_utils.py, with the tolerances of
  tests/test_parity.py:72-83 (fake 1e-4, D real 1e-4, D fake 5e-4), and the
  generator, histogram and discriminator losses on it (rtol 1e-4, Hellinger
  1e-3);
* the full-width generator gradients of the histogram variant's G loss
  (BCE + 30 L1 + Hellinger) against the TF tape gradients
  networks_grads_histogram.npz, with the checks and tolerances
  tests/test_parity.py:296-328 holds the JAX package to (every gradient's
  norm within 0.2%, small tensors whole, large ones along fixed random
  projections), through the default "tri" histogram and the float32 plain
  versions of the three kernel-backed configurations;
* the decoder's layout, in the RGBA (4 -> 4) and the indexed (1 -> 256)
  generator at full width: no transposed convolution reaches cuDNN; every
  UpBlock's convolution gets operands that cuDNN takes as channels-last
  (the input or the weight suggests it, `cudnn_conv_suggest_memory_format`'s
  rule), the 1x1 bottleneck's input included, and so do their input
  gradients' convolutions; the head gets contiguous NCHW input and gives
  NCHW logits; the counter reads 6 channels-last and 0 other a forward.
  Outputs, D's outputs on them and every parameter's gradient equal the
  NCHW decoder (cuDNN's transposed convolution on contiguous input, cat
  then pad) in float64, dropout on; the kept dropout positions are bit for
  bit those of a contiguous (B, C, H, W) draw;
* the forward-convolution lowerings of k4 s2 convolutions and transposed
  convolutions, forward and both gradients, in float64.
"""

import copy
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

from palette_and_histo_gan_tpu import config as jconfig
from palette_and_histo_gan_tpu.models import networks as jnet
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.models import networks as tnet
from palette_and_histo_gan_tpu_torch.ops import histogram as th
from palette_and_histo_gan_tpu_torch.train import losses as tl
from palette_and_histo_gan_tpu_torch.train import steps as tsteps
from tests import parity_utils as pu
from tests.test_parity import _assert_grads_match

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_conv_transpose_mapping():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    k = rng.standard_normal((4, 4, 6, 3)).astype(np.float32)
    ref = np.asarray(jnet._convt_k4s2_same(jnp.asarray(x), jnp.asarray(k)))
    out = F.conv_transpose2d(
        _nchw(x), torch.from_numpy(convert._conv_transpose(k)), stride=2, padding=1
    ).permute(0, 2, 3, 1)
    assert out.shape == (2, 10, 10, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_head_conv_pads_one_before_two_after():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 7, 5)).astype(np.float32)
    k = rng.standard_normal((4, 4, 5, 2)).astype(np.float32)
    ref = np.asarray(jnet._conv_k4s1_same(jnp.asarray(x), jnp.asarray(k)))
    head = tnet.HeadConv(5, 2)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(convert._conv(k)))
        head.bias.zero_()
        out = head(_nchw(x)).permute(0, 2, 3, 1)
        # a symmetric pad of 2 gives one row and column more, shifted
        sym = F.conv2d(_nchw(x), head.weight, padding=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert sym.shape[1] == 8
    np.testing.assert_allclose(sym[:, 1:, 1:].numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def narrow_flax():
    config = config_for_variant("histogram", **NARROW)
    jax_config = jconfig.config_for_variant("histogram", **NARROW)
    gen = jnet.build_generator(jax_config)
    disc = jnet.build_discriminator(jax_config)
    x = jnp.zeros((1, 64, 64, 4))
    g = gen.init(jax.random.PRNGKey(1), x, deterministic=True)["params"]
    d = disc.init(jax.random.PRNGKey(2), x, x)["params"]
    tree = jax.tree_util.tree_map(np.asarray, (g, d))
    return config, gen, disc, tree[0], tree[1]


def _torch_nets(config, g_tree, d_tree, dtype=torch.float32):
    g = tnet.build_generator(config, dtype)
    d = tnet.build_discriminator(config, dtype)
    convert.load_flax_params(g, d, g_tree, d_tree)
    return g, d


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def test_bridge_round_trip(narrow_flax):
    config, _, _, g_tree, d_tree = narrow_flax
    g, d = _torch_nets(config, g_tree, d_tree)
    back = {}
    for key, (path, layout) in convert._generator_key_map(6, 6).items():
        w = g.state_dict()[key].numpy()
        if layout is convert._conv:
            w = np.transpose(w, (2, 3, 1, 0))
        elif layout is convert._conv_transpose:
            w = np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
        back[path] = w
    flat = _flat(g_tree)
    assert sorted(back) == sorted(flat)
    for path, w in flat.items():
        np.testing.assert_array_equal(back[path], w)
    np.testing.assert_array_equal(
        d.state_dict()["down.weight"].numpy(),
        np.transpose(d_tree["DownBlock_0"]["Conv_0"]["kernel"], (3, 2, 0, 1)),
    )


def test_bridge_refuses_missing_and_unused(narrow_flax):
    config, _, _, g_tree, d_tree = narrow_flax
    g = tnet.build_generator(config, torch.float32)
    missing = {k: v for k, v in g_tree.items() if k != "Conv_0"}
    with pytest.raises(ValueError, match="no Conv_0/kernel"):
        convert.generator_state_dict_from_flax(missing, g)
    extra = dict(g_tree, Extra_0={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unused Flax leaves"):
        convert.generator_state_dict_from_flax(extra, g)


def test_narrow_forward_matches_flax(narrow_flax, monkeypatch):
    config, gen, disc, g_tree, d_tree = narrow_flax
    g, d = _torch_nets(config, g_tree, d_tree)
    rng = np.random.default_rng(3)
    src = rng.uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32)
    fake_j = gen.apply({"params": g_tree}, jnp.asarray(src), deterministic=True)
    pred_j = disc.apply({"params": d_tree}, jnp.asarray(tgt), jnp.asarray(src))
    # oneDNN's CPU convolution may sum in another order from one process to
    # the next, and InstanceNorm over the narrow net's 1x1 bottleneck divides
    # that rounding noise by sqrt(1e-3): the output then moves by ~2e-5
    # between runs. PyTorch's own CPU convolution sums in one fixed order.
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    with torch.no_grad():
        fake_t = g(torch.from_numpy(src), deterministic=True)
        pred_t = d(torch.from_numpy(tgt), torch.from_numpy(src))
    assert fake_t.shape == (2, 64, 64, 4) and pred_t.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(fake_t.numpy(), np.asarray(fake_j), atol=1e-5)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), atol=1e-5)


def test_dropout_is_drawn_from_the_generator(narrow_flax):
    config, _, _, g_tree, d_tree = narrow_flax
    g, _ = _torch_nets(config, g_tree, d_tree)
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32))
    outs = []
    with torch.no_grad():
        for seed in (5, 5, 6):
            gen = torch.Generator()
            gen.manual_seed(seed)
            outs.append(g(x, gen))
        with pytest.raises(ValueError, match="explicit torch.Generator"):
            g(x)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])


@pytest.fixture(scope="module")
def golden_rgba():
    g = np.load(os.path.join(GOLDEN, "networks_rgba.npz"))
    config = config_for_variant("histogram")
    gen, disc = _torch_nets(
        config, pu.flax_generator_params(4, 4), pu.flax_discriminator_params(4)
    )
    src, real = torch.from_numpy(g["source"]), torch.from_numpy(g["real"])
    with torch.no_grad():
        fake = gen(src, deterministic=True)
        d_real = disc(real, src)
        d_fake = disc(fake, src)
    return g, real, fake, d_real, d_fake


def test_full_width_forward_matches_golden(golden_rgba):
    g, _, fake, d_real, d_fake = golden_rgba
    np.testing.assert_allclose(fake.numpy(), g["fake"], atol=1e-4)
    np.testing.assert_allclose(d_real.numpy(), g["d_real"], atol=1e-4)
    np.testing.assert_allclose(d_fake.numpy(), g["d_fake"], atol=5e-4)


def test_full_width_losses_match_golden(golden_rgba):
    g, real, fake, d_real, d_fake = golden_rgba
    base = tl.generator_loss(d_fake, fake, real, 100.0)
    np.testing.assert_allclose(float(base["adversarial_loss"]), g["g_adversarial"], rtol=1e-4)
    np.testing.assert_allclose(float(base["l1_loss"]), g["g_l1"], rtol=1e-4)
    np.testing.assert_allclose(float(base["total_loss"]), g["g_total_baseline"], rtol=1e-4)
    hist = tl.generator_loss(d_fake, fake, real, 30.0)
    hell = th.hellinger_loss(
        th.calculate_rgbuv_histogram(real), th.calculate_rgbuv_histogram(fake)
    )
    np.testing.assert_allclose(float(hell), g["hellinger"], rtol=1e-3)
    np.testing.assert_allclose(
        float(hist["total_loss"] + hell), g["g_total_histogram"], rtol=1e-4
    )
    d = tl.discriminator_loss(d_real, d_fake)
    np.testing.assert_allclose(float(d["real_loss"]), g["d_real_loss"], rtol=1e-4)
    np.testing.assert_allclose(float(d["fake_loss"]), g["d_fake_loss"], rtol=1e-4)
    np.testing.assert_allclose(float(d["total_loss"]), g["d_total"], rtol=1e-4)


def _generator_grads_to_tf(generator, grads):
    """The port's generator gradients under the canonical TF names: back
    through the bridge's layouts to a Flax tree, then parity_utils."""
    tree = {}
    for key, (path, layout) in convert._generator_key_map(6, 6).items():
        g = grads[key].numpy()
        if layout is convert._conv:
            g = np.transpose(g, (2, 3, 1, 0))
        elif layout is convert._conv_transpose:
            g = np.transpose(g, (2, 3, 0, 1))[::-1, ::-1]
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = g
    return pu.flax_generator_grads_to_tf(tree)


@pytest.fixture(scope="module")
def golden_histogram_graph():
    """The full-width generator's fake and D's prediction on it, with the
    graph kept for one backward per histogram configuration."""
    g = np.load(os.path.join(GOLDEN, "networks_rgba.npz"))
    config = config_for_variant("histogram")
    gen, disc = _torch_nets(
        config, pu.flax_generator_params(4, 4), pu.flax_discriminator_params(4)
    )
    disc.requires_grad_(False)
    src, real = torch.from_numpy(g["source"]), torch.from_numpy(g["real"])
    fake = gen(src, deterministic=True)
    return gen, real, fake, disc(fake, src)


@pytest.mark.parametrize(
    "histogram_impl,histogram_bwd",
    [("xla", "tri"), ("pallas", "tri"), ("pallas2", "tri"), ("xla", "pallas")],
)
def test_histogram_generator_gradients_match_tf(golden_histogram_graph, histogram_impl, histogram_bwd):
    gen, real, fake, d_fake = golden_histogram_graph
    config = config_for_variant(
        "histogram", histogram_impl=histogram_impl, histogram_bwd=histogram_bwd
    )
    hist_fn = tsteps.histogram_fn(config)
    kw = dict(size=config.histogram_size, method=config.histogram_method,
              sigma=config.histogram_sigma, dtype=torch.float32)
    loss = tl.generator_loss(d_fake, fake, real, 30.0)["total_loss"] + th.hellinger_loss(
        hist_fn(real, **kw), hist_fn(fake, **kw)
    )
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    fixture = np.load(os.path.join(GOLDEN, "networks_grads_histogram.npz"))
    _assert_grads_match(_generator_grads_to_tf(gen, dict(zip(names, grads))), fixture, "g.")


def _full_width(variant: str, dtype=torch.float32):
    config = config_for_variant(variant)
    g = tnet.build_generator(config, dtype).to(dtype)
    d = tnet.build_discriminator(config, dtype).to(dtype)
    draw = torch.Generator().manual_seed(0)
    tnet.init_parameters(g, draw)
    tnet.init_parameters(d, draw)
    rng = np.random.default_rng(1)
    source = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, config.generator_in_channels)))
    return g, d, source.to(dtype)


def _nchw_generator(g, x, generator):
    """UnetGenerator.forward(..., logits=True) with the decoder written as
    plain NCHW PyTorch: F.conv_transpose2d on contiguous input, a contiguous
    dropout mask, the last skip concatenated and then padded by the head."""
    x = x.permute(0, 3, 1, 2)
    inputs, skips = x, []
    for block in g.down:
        x = block(x)
        skips.append(x)
    for block, skip in zip(g.up, list(reversed(skips[:-1])) + [inputs]):
        x = block.norm(F.conv_transpose2d(x.contiguous(), block.weight, stride=2, padding=1))
        if block.apply_dropout:
            keep = torch.rand(x.shape, generator=generator) < 1.0 - tnet.DROPOUT_RATE
            x = torch.where(keep, x / (1.0 - tnet.DROPOUT_RATE), torch.zeros_like(x))
        x = torch.cat([F.relu(x), skip], dim=1)
    return g.head(x.contiguous()).permute(0, 2, 3, 1)


def _discriminated(d, out, source):
    """D's prediction on the generator's output: the RGBA image, or the
    indexed generator's expected index (a differentiable stand-in for the
    argmax map the indexed step gives D)."""
    if out.shape[-1] != source.shape[-1]:
        out = (out * torch.arange(out.shape[-1], dtype=out.dtype)).sum(-1, keepdim=True)
    return d(out, source)


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_decoder_runs_channels_last_to_an_nchw_head(variant, monkeypatch):
    g, _, source = _full_width(variant)
    calls = []
    backward = []

    def recorded(name):
        conv = getattr(F, name)

        def call(x, weight, *args, **kwargs):
            out = conv(x, weight, *args, **kwargs)
            entry = dict(name=name, backward=bool(backward), spatial=tuple(x.shape[-2:]),
                         stride=kwargs.get("stride", 1), x=suggest_memory_format(x),
                         weight=suggest_memory_format(weight), out=out, grad=[])
            if out.requires_grad:
                out.register_hook(lambda grad: entry["grad"].append(suggest_memory_format(grad)))
            calls.append(entry)
            return out

        return call

    functional = types.SimpleNamespace(**vars(F))
    functional.conv2d, functional.conv_transpose2d = recorded("conv2d"), recorded("conv_transpose2d")
    monkeypatch.setattr(tnet, "F", functional)
    tnet.reset_conv_transpose_layouts()
    logits = g(source, torch.Generator().manual_seed(2), logits=True)
    assert tnet.conv_transpose_layouts == {"channels_last": 6, "other": 0}
    backward.append(True)
    logits.square().sum().backward()

    # no transposed convolution reaches cuDNN: each is a forward convolution
    assert [c["name"] for c in calls] == ["conv2d"] * len(calls)
    forward = [c for c in calls if not c["backward"]]
    down, up, head = forward[:6], forward[6:12], forward[12:]
    assert [c["stride"] for c in down] == [2] * 6 and [c["stride"] for c in up] == [1] * 6
    assert [c["spatial"] for c in up] == [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (32, 32)]
    for c in down + up:
        assert torch.channels_last in (c["x"], c["weight"]), c["spatial"]
    # the up blocks' input gradients (forward convolutions of their output
    # gradients), NHWC as well
    up_grads = [c for c in calls if c["backward"] and c["stride"] == 2]
    assert [c["spatial"] for c in up_grads] == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    assert all(torch.channels_last in (c["x"], c["weight"]) for c in up_grads)
    (head,) = head
    assert head["spatial"] == (67, 67)
    assert head["x"] == head["weight"] == torch.contiguous_format
    assert head["out"].is_contiguous() and head["grad"] == [torch.contiguous_format]
    # the indexed losses' kernel takes the logits as NCHW memory viewed NHWC
    assert logits.permute(0, 3, 1, 2).is_contiguous()
    assert all(p.is_contiguous() and p.grad.is_contiguous() for p in g.parameters())


def _instance_norm_float64(self, x):
    """InstanceNorm.forward's float32 formula in the input's dtype."""
    mean = x.mean((2, 3), keepdim=True)
    var = x.var((2, 3), keepdim=True, unbiased=False)
    normed = (x - mean) * torch.rsqrt(var + self.eps)
    return normed * self.scale.view(1, -1, 1, 1) + self.offset.view(1, -1, 1, 1)


@pytest.mark.parametrize("variant", ["histogram", "indexed"])
def test_channels_last_decoder_equals_the_nchw_formulation(variant, monkeypatch):
    # in float64 throughout (InstanceNorm rounds to float32 otherwise): a
    # float32 sum in another order can move a pre-activation of ~1e-7
    # across ReLU's kink, which moves every gradient below it by ~1e-3 of
    # its norm
    monkeypatch.setattr(tnet.InstanceNorm, "forward", _instance_norm_float64)
    g, d, source = _full_width(variant, torch.float64)
    ref_g, ref_d = copy.deepcopy(g), copy.deepcopy(d)
    results = []
    for gen_net, disc_net, forward in ((g, d, functools.partial(g, logits=True)),
                                      (ref_g, ref_d, functools.partial(_nchw_generator, ref_g))):
        logits = forward(source, torch.Generator().manual_seed(3))
        out = torch.tanh(logits) if g.last_activation == "tanh" else torch.softmax(logits, dim=-1)
        pred = _discriminated(disc_net, out, source)
        weights = torch.Generator().manual_seed(4)
        loss = sum((t * torch.randn(t.shape, generator=weights)).sum() for t in (logits, pred))
        loss.backward()
        grads = [p.grad for p in (*gen_net.parameters(), *disc_net.parameters())]
        results.append((logits.detach(), pred.detach(), grads))
    (logits, pred, grads), (ref_logits, ref_pred, ref_grads) = results
    # float64 sums in another order
    torch.testing.assert_close(logits, ref_logits, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(pred, ref_pred, rtol=1e-10, atol=1e-12)
    names = [n for net in (g, d) for n, _ in net.named_parameters()]
    for name, got, want in zip(names, grads, ref_grads):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12 * max(scale, 1.0), msg=name)


@pytest.mark.parametrize("rows,first_row", [(None, 0), (5, 2)])
def test_dropout_keeps_the_positions_of_a_contiguous_draw(rows, first_row):
    block = tnet.UpBlock(16, 8, apply_dropout=True)
    tnet.init_parameters(block, torch.Generator().manual_seed(5))
    x = torch.randn((3, 16, 4, 4), generator=torch.Generator().manual_seed(6))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        dropped = block(x, tnet.DropoutDraw(torch.Generator().manual_seed(7), rows, first_row))
        undropped = block(x, deterministic=True)
    drawn = torch.rand((rows or 3, 8, 8, 8), generator=torch.Generator().manual_seed(7))
    keep = drawn[first_row:first_row + 3] < 1.0 - tnet.DROPOUT_RATE
    assert dropped.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dropped, torch.where(keep, undropped / (1.0 - tnet.DROPOUT_RATE), 0.0))


@pytest.mark.parametrize("side", [1, 2, 4, 8])
@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
def test_k4s2_lowerings_equal_the_convolutions(side, memory_format):
    """The two autograd Functions built on the subpixel transposed
    convolution, forward and both gradients, against F.conv_transpose2d and
    F.conv2d (k4 s2 padding 1) in float64."""
    g = torch.Generator().manual_seed(side)

    def draw(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    x = draw(3, 6, side, side).contiguous(memory_format=memory_format).requires_grad_()
    w = draw(6, 5, 4, 4).requires_grad_()
    cotangent = draw(3, 5, 2 * side, 2 * side)
    pairs = [(tnet._ConvTransposeK4S2.apply, lambda a, b: F.conv_transpose2d(a, b, stride=2, padding=1),
              x, cotangent),
             (tnet._ConvK4S2.apply, lambda a, b: F.conv2d(a, b, stride=2, padding=1),
              draw(3, 5, 2 * side, 2 * side).contiguous(memory_format=memory_format).requires_grad_(),
              draw(3, 6, side, side))]
    for lowered, plain, inp, cot in pairs:
        got, want = lowered(inp, w), plain(inp, w)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        for a, b in zip(torch.autograd.grad(got, (inp, w), cot), torch.autograd.grad(want, (inp, w), cot)):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
