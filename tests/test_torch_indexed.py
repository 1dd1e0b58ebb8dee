"""The PyTorch port's indexed variant against the JAX package and the TF
goldens.

* the port's own `Config` against the JAX package's: the same fields and
  defaults, and `config_for_variant` agreeing for every variant;
* `make_indexed_datasets` on a synthetic dataset root (random 64x64
  sprites: every pair has more than 256 colours, so every palette
  truncates) against the JAX loader, exact, under each deterministic
  ordering; the few-colour synthetic set has labels past 255 and
  truncated pairs;
* the indexed losses (keras CCE and one-hot L1, probabilities and logits
  forms) against JAX's, values (rtol 1e-6; float32 on both sides) and
  gradients (atol 1e-7 on entries of ~1e-5), with labels past 255;
* the full-width indexed forward (1-channel input, 33 -> 256 head)
  against `networks_indexed.npz` with tests/test_parity.py:155-186's
  tolerances (probabilities 1e-5, argmax maps agree on > 99.9% of pixels,
  D real 1e-4 and fake 5e-4, losses rtol 1e-4, L1 1e-3), and the G and D
  gradients of the indexed step's losses against
  `networks_grads_indexed.npz` (`_assert_grads_match`);
* three narrow indexed steps against JAX's `indexed_train_step` from the
  same bridged weights on the same few-colour index maps: losses within
  rtol 1e-4, the parameter deltas within 1e-3 of each delta in Frobenius
  norm;
* the 6-step full-width closed loop against TF (`trajectory_indexed.npz`)
  with tests/test_parity.py's curve tolerances and TIGHT_TOLS /
  FINAL_TOLS;
* the generate and L1 path, and a narrow indexed CLI run on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu import config as jconfig
from palette_and_histo_gan_tpu.data import loader as jloader
from palette_and_histo_gan_tpu.train import losses as jl
from palette_and_histo_gan_tpu.train import steps as jsteps
from palette_and_histo_gan_tpu_torch import cli as tcli
from palette_and_histo_gan_tpu_torch import config as tconfig
from palette_and_histo_gan_tpu_torch.data import loader as tloader
from palette_and_histo_gan_tpu_torch.eval import metrics as tmetrics
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.models import networks as tnet
from palette_and_histo_gan_tpu_torch.ops import palette as tp
from palette_and_histo_gan_tpu_torch.train import losses as tl
from palette_and_histo_gan_tpu_torch.train import state as tstate
from palette_and_histo_gan_tpu_torch.train import steps as tsteps
from tests import parity_utils as pu
from tests.test_data import _write_synthetic_root
from tests.test_parity import (
    FINAL_TOLS,
    N_TIGHT_STEPS,
    TIGHT_TOLS,
    _assert_curve,
    _assert_grads_match,
    _trajectory_index_maps,
)
from tests.test_torch_train_step import NARROW, configs, same_init_states

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


# ------------------------------------------------------------------ config


def test_config_has_the_jax_fields_and_defaults(monkeypatch):
    monkeypatch.setenv("PHG_DATA_ROOT", "/data/sprites")  # both defaults read it
    ours = {f.name: f for f in dataclasses.fields(tconfig.Config)}
    theirs = {f.name: f for f in dataclasses.fields(jconfig.Config)}
    assert list(ours) == list(theirs)
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    for name in ("SEED", "DIRECTIONS", "DIRECTION_FOLDERS", "DATASET_SIZES", "TRAIN_PERCENTAGE",
                 "MAX_PALETTE_SIZE", "INVALID_INDEX_COLOR", "MODEL_VARIANTS", "PALETTE_ORDERINGS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    with pytest.raises(ValueError, match="palette_ordering"):
        tconfig.Config(palette_ordering="random")


PROPERTIES = ("architecture_name", "effective_data_roots", "train_sizes", "test_sizes",
              "train_size", "steps", "update_steps", "is_indexed", "generator_in_channels",
              "generator_out_channels", "generator_last_activation",
              "discriminator_in_channels", "effective_lambda_l1", "uses_augmentation")


@pytest.mark.parametrize("variant", tconfig.MODEL_VARIANTS)
def test_config_for_variant_agrees_with_jax(variant):
    kw = dict(data_root="/data/sprites", batch_size=8, dataset_sizes=(30,))
    ours, theirs = tconfig.config_for_variant(variant, **kw), jconfig.config_for_variant(variant, **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for name in PROPERTIES:
        assert getattr(ours, name) == getattr(theirs, name), name
    tconfig.check_supported(ours, "cpu")


# -------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("indexed") / "ds")
    _write_synthetic_root(root, 8, seed=6)
    return root


@pytest.mark.parametrize("ordering", ["grayness", "top2bottom", "bottom2top"])
def test_make_indexed_datasets_matches_jax(synthetic_root, ordering):
    jax_config, config = configs("indexed", data_root=synthetic_root, dataset_sizes=(8,),
                                 palette_ordering=ordering)
    ours = tloader.make_indexed_datasets(config, "cpu")
    ref = jloader.make_indexed_datasets(jax_config)
    for o, r in zip(ours, ref):
        assert o.n == r.n
        for name in ("sources", "targets", "palettes"):
            got = getattr(o, name)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(r, name)), err_msg=name)
    assert (ours[0].n, ours[1].n) == (7, 1)


def test_synthetic_indexed_set_has_the_quirks():
    """Few colours a pair, labels past 255 (hotpink pixels) and truncated
    palettes (more than 256 colours in a pair)."""
    config = tconfig.config_for_variant("indexed", dataset_sizes=(30,))
    arrays = tloader.synthetic_indexed_arrays(config, 3)
    train, test = tloader.indexed_datasets_from_arrays(*arrays, "cpu")
    assert (train.n, test.n) == (26, 4)
    assert int(train.sources.max()) > 255 or int(train.targets.max()) > 255
    hot = torch.tensor(tconfig.INVALID_INDEX_COLOR, dtype=torch.int32)
    full = ~(train.palettes[:, -1] == hot).all(-1)  # no filler slot left
    assert full.any() and not full.all()
    batch = tloader.gather_indexed_batch(train, torch.tensor([3, 0]))
    assert [tuple(t.shape) for t in batch] == [(2, 64, 64, 1), (2, 64, 64, 1), (2, 256, 4)]


# ------------------------------------------------------------------ losses


def _loss_inputs(dtype):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 8, 8, 256)).astype(np.float32) * 3.0
    labels = rng.integers(0, 256, (2, 8, 8)).astype(np.int32)
    labels[0, 0, :3] = (256, 300, 32157)  # past 255: an all-zero one-hot row
    logits = torch.from_numpy(logits).to(dtype)
    return labels, logits


LOSSES = {
    "sparse_cce_logits": (tl.sparse_categorical_crossentropy_logits,
                          jl.sparse_categorical_crossentropy_logits, "logits"),
    "onehot_l1_logits": (tl.onehot_l1_logits, jl.onehot_l1_logits, "logits"),
    "sparse_cce_probs": (tl.sparse_categorical_crossentropy_probs,
                         jl.sparse_categorical_crossentropy_probs, "probs"),
    "onehot_l1_probs": (tl.onehot_l1_probs, jl.onehot_l1_probs, "probs"),
    "cce_probs": (tl.categorical_crossentropy_probs, jl.categorical_crossentropy_probs, "onehot"),
}


# the logits forms also on bfloat16 logits (the bf16 step's); the
# probabilities forms take float32 softmax outputs
LOSS_CASES = [(name, torch.float32) for name in LOSSES] + [
    (name, torch.bfloat16) for name, (_, _, form) in LOSSES.items() if form == "logits"
]


@pytest.mark.parametrize("name,dtype", LOSS_CASES)
def test_indexed_losses_match_jax(name, dtype):
    ours_fn, jax_fn, form = LOSSES[name]
    labels, logits = _loss_inputs(dtype)
    x = logits.clone().requires_grad_(True)
    jx = jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)

    def prepare_t(z):
        return z if form == "logits" else torch.softmax(z.float(), -1)

    def prepare_j(z):
        return z if form == "logits" else jax.nn.softmax(z.astype(jnp.float32), -1)

    if form == "onehot":
        onehot = np.eye(257, dtype=np.float32)[np.minimum(labels, 256)][..., :256]
        value = ours_fn(torch.from_numpy(onehot), prepare_t(x))
        jvalue, jgrad = jax.value_and_grad(lambda z: jax_fn(jnp.asarray(onehot), prepare_j(z)))(jx)
    else:
        value = ours_fn(torch.from_numpy(labels), prepare_t(x))
        jvalue, jgrad = jax.value_and_grad(lambda z: jax_fn(jnp.asarray(labels), prepare_j(z)))(jx)
    (grad,) = torch.autograd.grad(value, x)
    assert value.dtype == torch.float32
    np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=1e-6)
    atol = 1e-7 if dtype == torch.float32 else 2e-8  # bf16 grads: ~4e-6 entries, 8 bits
    np.testing.assert_allclose(grad.float().numpy(), np.asarray(jgrad, np.float32),
                               atol=atol, rtol=1e-2 if dtype == torch.bfloat16 else 1e-5)
    # labels past 255 contribute nothing to the gradient
    assert float(grad[0, 0, :3].float().abs().max()) == 0.0


# --------------------------------------------------- full width vs TF goldens


def _tree_to_tf(tensors: dict, key_map: dict, to_tf) -> dict:
    """The port's tensors (state_dict or gradients) under the canonical TF
    names: back through the bridge's layouts to a Flax tree, then
    parity_utils."""
    tree = {}
    for key, (path, layout) in key_map.items():
        g = tensors[key].detach().double().numpy()
        if layout is convert._conv:
            g = np.transpose(g, (2, 3, 1, 0))
        elif layout is convert._conv_transpose:
            g = np.transpose(g, (2, 3, 0, 1))[::-1, ::-1]
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = g
    return to_tf(tree)


def _g_to_tf(tensors):
    return _tree_to_tf(tensors, convert._generator_key_map(6, 6), pu.flax_generator_grads_to_tf)


def _d_to_tf(tensors):
    return _tree_to_tf(tensors, convert._discriminator_key_map(), pu.flax_discriminator_grads_to_tf)


def _full_width_nets():
    config = tconfig.config_for_variant("indexed")
    gen = tnet.build_generator(config, torch.float32)
    disc = tnet.build_discriminator(config, torch.float32)
    convert.load_flax_params(gen, disc, pu.flax_generator_params(1, 256),
                             pu.flax_discriminator_params(1))
    return gen, disc


@pytest.fixture(scope="module")
def golden_indexed():
    """The full-width generator's logits on the fixture's source, with the
    graph kept for the gradient checks."""
    g = np.load(os.path.join(GOLDEN, "networks_indexed.npz"))
    gen, disc = _full_width_nets()
    source = torch.from_numpy(g["source"])
    logits = gen(source, deterministic=True, logits=True)
    return g, gen, disc, source, logits


def test_full_width_indexed_forward_matches_golden(golden_indexed):
    g, gen, disc, source, logits = golden_indexed
    with torch.no_grad():
        probs = gen(source, deterministic=True)
        fake_idx = torch.argmax(logits, -1, keepdim=True).int()
        d_real = disc(torch.from_numpy(g["real"]).float(), source)
        # the fixture's argmax map, as tests/test_parity.py feeds it: one
        # flipped pixel is an O(100) input change to D
        d_fake = disc(torch.from_numpy(g["fake_idx"]).float(), source)
    assert probs.dtype == torch.float32 and probs.shape == (2, 64, 64, 256)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 64, 64), rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs[:, ::8, ::8].numpy(), g["probs_slice"], atol=1e-5)
    assert (fake_idx.numpy() == g["fake_idx"]).mean() > 0.999
    np.testing.assert_allclose(d_real.numpy(), g["d_real"], atol=1e-4)
    np.testing.assert_allclose(d_fake.numpy(), g["d_fake"], atol=5e-4)

    labels = torch.from_numpy(g["real"])[..., 0]
    seg = tl.sparse_categorical_crossentropy_probs(labels, probs)
    np.testing.assert_allclose(float(seg), g["segmentation"], rtol=1e-4)
    logits = logits.detach()
    np.testing.assert_allclose(float(tl.sparse_categorical_crossentropy_logits(labels, logits)),
                               g["segmentation"], rtol=1e-4)
    np.testing.assert_allclose(float(tl.onehot_l1_probs(labels, probs)), g["g_l1"], rtol=1e-3)
    np.testing.assert_allclose(float(tl.onehot_l1_logits(labels, logits)), g["g_l1"], rtol=1e-3)
    adv = tl.bce_with_logits(torch.ones_like(d_fake), d_fake)
    np.testing.assert_allclose(float(adv), g["g_adversarial"], rtol=1e-4)
    np.testing.assert_allclose(float(adv) + 0.01 * float(seg), g["g_total"], rtol=1e-4)
    d = tl.discriminator_loss(d_real, d_fake)
    np.testing.assert_allclose(float(d["total_loss"]), g["d_total"], rtol=1e-4)


def test_full_width_indexed_gradients_match_tf(golden_indexed):
    """The indexed step's G loss (the adversarial term blocked by argmax,
    plus 0.01 * the sparse CCE on logits) and D loss (its own argmax map),
    gradients against the TF tape's."""
    g, gen, disc, source, logits = golden_indexed
    labels = torch.from_numpy(g["real"])[..., 0]
    fake = torch.argmax(logits, -1, keepdim=True).float()
    with torch.no_grad():
        d_fake = disc(fake, source)
    loss = (tl.bce_with_logits(torch.ones_like(d_fake), d_fake)
            + 0.01 * tl.sparse_categorical_crossentropy_logits(labels, logits))
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    fixture = np.load(os.path.join(GOLDEN, "networks_grads_indexed.npz"))
    _assert_grads_match(_g_to_tf(dict(zip(names, grads))), fixture, "g.")

    real = torch.from_numpy(g["real"]).float()
    d_loss = tl.discriminator_loss(disc(real, source), disc(fake, source))["total_loss"]
    names, params = zip(*disc.named_parameters())
    grads = torch.autograd.grad(d_loss, params)
    _assert_grads_match(_d_to_tf(dict(zip(names, grads))), fixture, "d.")


# ------------------------------------------------------------------- steps


@pytest.fixture(scope="module")
def few_colour_maps():
    """Index maps of the few-colour synthetic set (labels past 255 in
    it), three batches of two pairs."""
    config = tconfig.config_for_variant("indexed", dataset_sizes=(12,))
    train, _ = tloader.indexed_datasets_from_arrays(
        *tloader.synthetic_indexed_arrays(config, 4), "cpu"
    )
    assert int(train.sources.max()) > 255
    return [(train.sources[i:i + 2].numpy(), train.targets[i:i + 2].numpy())
            for i in (0, 4, 8)]


def test_three_indexed_steps_match_jax(few_colour_maps, monkeypatch):
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)  # one summation order
    jax_config, config = configs("indexed", deterministic_dropout=True, donate_state=False,
                                 **NARROW)
    models, jax_state, state = same_init_states(jax_config, config)
    g0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    jax_g0 = jax.tree_util.tree_map(np.asarray, jax_state.g_params)
    jax_d0 = jax.tree_util.tree_map(np.asarray, jax_state.d_params)

    jax_step = jsteps.make_train_step(jax_config, models)
    torch_step = tsteps.make_train_step(config)
    for src, tgt in few_colour_maps:
        jax_state, jm = jax_step(jax_state, jnp.asarray(src), jnp.asarray(tgt))
        tm = torch_step(state, torch.from_numpy(src), torch.from_numpy(tgt))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == 3 == int(jax_state.step)

    for net, init, jax_init, jax_final, to_sd in (
        (state.generator, g0, jax_g0, jax_state.g_params, convert.generator_state_dict_from_flax),
        (state.discriminator, d0, jax_d0, jax_state.d_params,
         convert.discriminator_state_dict_from_flax),
    ):
        ref0 = to_sd(jax_init, net)
        ref1 = to_sd(jax.tree_util.tree_map(np.asarray, jax_final), net)
        for k, w in net.state_dict().items():
            delta = (w - init[k]).numpy()
            ref = (ref1[k] - ref0[k]).numpy()
            assert np.linalg.norm(delta - ref) <= 1e-3 * np.linalg.norm(ref), k


def test_indexed_trajectory_matches_tf():
    """Six full-width steps from the parity weights with co-evolving G and
    D, dropout off, on the index maps tests/test_parity.py makes from its
    seed: every loss curve, the step-2 deltas (tight) and the final deltas
    (gross structure) against the TF reference."""
    g = np.load(os.path.join(GOLDEN, "trajectory_indexed.npz"))
    config = tconfig.config_for_variant("indexed", deterministic_dropout=True)
    state = tstate.create_train_state(config, "cpu", seed=0)
    convert.load_flax_params(state.generator, state.discriminator,
                             pu.flax_generator_params(1, 256), pu.flax_discriminator_params(1))
    g0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in state.discriminator.state_dict().items()}

    def snapshot():
        return (
            _g_to_tf({k: v - g0[k] for k, v in state.generator.state_dict().items()}),
            _d_to_tf({k: v - d0[k] for k, v in state.discriminator.state_dict().items()}),
        )

    src = _trajectory_index_maps("trajectory/indexed/source").astype(np.int32)
    tgt = _trajectory_index_maps("trajectory/indexed/target").astype(np.int32)
    step = tsteps.make_train_step(config)
    curves, tight = [], None
    for i, (s, t) in enumerate(zip(src, tgt)):
        metrics = step(state, torch.from_numpy(s), torch.from_numpy(t))
        curves.append({k: float(v) for k, v in metrics.items()})
        if i + 1 == N_TIGHT_STEPS:
            tight = snapshot()
    final = snapshot()
    _assert_curve(curves, "generator/total_loss", g["g_total"], 2e-3, "G total")
    _assert_curve(curves, "discriminator/total_loss", g["d_total"], 1e-3, "D total")
    _assert_curve(curves, "generator/adversarial_loss", g["g_adv"], 2e-3, "G adv")
    _assert_curve(curves, "generator/segmentation_loss", g["segmentation"], 2e-3, "seg")
    _assert_grads_match(tight[0], g, "g2.", **TIGHT_TOLS)
    _assert_grads_match(tight[1], g, "d2.", **TIGHT_TOLS)
    _assert_grads_match(final[0], g, "g.", **FINAL_TOLS)
    _assert_grads_match(final[1], g, "d.", **FINAL_TOLS)


# ------------------------------------------------------- generate, trainer


def test_generate_and_l1_report_decode_through_the_palettes():
    config = tconfig.config_for_variant("indexed", dataset_sizes=(8,), **NARROW)
    train, test = tloader.indexed_datasets_from_arrays(
        *tloader.synthetic_indexed_arrays(config, 5), "cpu"
    )
    state = tstate.create_train_state(config, "cpu", seed=1)
    drop = torch.Generator()
    drop.manual_seed(0)
    fake = tsteps.generate(config, state.generator, train.sources[:3], drop)
    assert fake.dtype == torch.int32 and fake.shape == (3, 64, 64, 1)
    assert int(fake.min()) >= 0 and int(fake.max()) < 256
    drop.manual_seed(0)
    real, fake_rgba = tmetrics.generate_split(config, state.generator, train, 3, drop)
    np.testing.assert_array_equal(real.numpy(),
                                  tp.indexed_to_rgba(train.targets[:3], train.palettes[:3]).float())
    np.testing.assert_array_equal(fake_rgba.numpy(),
                                  tp.indexed_to_rgba(fake, train.palettes[:3]).float())
    l1 = tmetrics.report_l1(config, state.generator, train, test, 1, seed=3)
    assert all(0.0 <= v <= 255.0 for v in l1)


def test_cli_trains_indexed_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the metrics writer logs under ./temp-side2side
    narrow = ["8"] * 6
    rc = tcli.main([
        "--model", "indexed", "--steps", "2", "--update-steps", "1", "--batch-size", "2",
        "--device", "cpu", "--synthetic", "--palette-ordering", "bottom2top",
        "--lambda-segmentation", "0.02", "--down-filters", *narrow, "--up-filters", *narrow,
        "--callbacks", "evaluate_l1",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Starting training for indexed" in out and "on cpu: 2 steps" in out
    assert "L1:" in out
    assert (tmp_path / "temp-side2side" / "logs").is_dir()


def test_cli_device_defaults_to_cuda():
    args = tcli.build_parser().parse_args(["--model", "indexed"])
    assert args.device == "cuda"
    assert set(tcli.build_parser()._option_string_actions["--model"].choices) == set(
        tconfig.MODEL_VARIANTS
    )
