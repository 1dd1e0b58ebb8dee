"""The port's bfloat16 train step against the JAX package's.

Three narrow steps (8 filters a stage, batch 2) of baseline-no-aug and of
histogram under "xla"/"tri" and "pallas2", compute_dtype "bfloat16" on
both sides, from the same bridged weights on the same uint8 batches, with
deterministic dropout and augment_probability 0 (the augmentation only
normalizes). The JAX side runs `augment_impl="pallas"` in interpret mode:
its kernel writes the normalized batch in the compute dtype, as the port's
augmentation always does (on the TPU, "auto" is that kernel). Its CPU
default, "auto", runs the XLA augmentation, which writes a float32 target,
so the L1 term sees another target; `test_jax_cpu_default_moves_the_l1`
shows that, so the setting stays.

* per-step losses within rtol 2e-3 (measured 7.0e-4 at worst, the
  Hellinger loss of "pallas2" at step 1; every loss within 1.1e-4 at step
  0);
* the parameter deltas after three steps, each network's as one vector,
  within BF16_DELTA_REL of the JAX deltas in Frobenius norm. Measured: G
  0.443-0.473, D 0.047-0.050. That is bfloat16's own scale: the JAX bf16
  step against the JAX float32 step reads G 0.410-0.442, D 0.057. Adam's
  m / (sqrt(v) + eps) turns the rounding of small gradients into whole
  steps, and near the 1x1 bottleneck every gradient is rounding (exactly
  zero in float32: InstanceNorm over one pixel). Besides, XLA on the CPU
  sums the discriminator head bias's bfloat16 cotangent in bfloat16: its
  real and fake halves stall at -0.125 and +0.125 (float32: -0.4976 and
  +0.5023), so JAX's head bias never moves, while the port sums in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.train import steps as jsteps
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.train import steps as tsteps
from tests.test_torch_train_step import NARROW, configs, same_init_states

BF16_LOSS_RTOL = 2e-3
BF16_DELTA_REL = {"generator": 0.7, "discriminator": 0.1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread while this file runs: the suite
    runs several test processes on the host's cores at once, and a thread a
    core in each makes them contend (tests/test_torch_fid.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def bf16_steps(variant: str, steps: int, jax_augment: str = "pallas", **overrides):
    """`steps` bfloat16 steps on both sides; returns the per-step metrics
    (port, JAX) and, per network, the port's and the JAX deltas as flat
    float64 vectors."""
    jax_config, config = configs(
        variant, deterministic_dropout=True, augment_probability=0.0, donate_state=False,
        compute_dtype="bfloat16", augment_impl="pallas", **overrides, **NARROW,
    )
    jax_config = dataclasses.replace(jax_config, augment_impl=jax_augment)
    models, jax_state, state = same_init_states(jax_config, config)
    nets = {"generator": (state.generator, convert.generator_state_dict_from_flax),
            "discriminator": (state.discriminator, convert.discriminator_state_dict_from_flax)}
    init = {name: {k: v.clone() for k, v in net.state_dict().items()}
            for name, (net, _) in nets.items()}
    jax_init = jax.tree_util.tree_map(np.asarray, (jax_state.g_params, jax_state.d_params))

    jax_step = jsteps.make_train_step(jax_config, models)
    torch_step = tsteps.make_train_step(config)
    rng = np.random.default_rng(1)
    curves = []
    for _ in range(steps):
        src, tgt = (rng.integers(0, 256, (2, 64, 64, 4), dtype=np.uint8) for _ in range(2))
        with pltpu.force_tpu_interpret_mode():
            jax_state, jm = jax_step(jax_state, jnp.asarray(src), jnp.asarray(tgt))
        tm = torch_step(state, torch.from_numpy(src), torch.from_numpy(tgt))
        assert sorted(tm) == sorted(jm)
        curves.append(({k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}))

    jax_final = jax.tree_util.tree_map(np.asarray, (jax_state.g_params, jax_state.d_params))
    deltas = {}
    for (name, (net, to_sd)), tree0, tree1 in zip(nets.items(), jax_init, jax_final):
        ref0, ref1 = to_sd(tree0, net), to_sd(tree1, net)
        keys = sorted(ref0)
        flat = lambda d: torch.cat([d[k].double().reshape(-1) for k in keys]).numpy()
        ours = {k: v - init[name][k] for k, v in net.state_dict().items()}
        deltas[name] = (flat(ours), flat(ref1) - flat(ref0))
    return curves, deltas


@pytest.mark.parametrize("variant,overrides", [
    ("baseline-no-aug", {}),
    ("histogram", dict(histogram_impl="xla")),
    ("histogram", dict(histogram_impl="pallas2")),
], ids=["baseline-no-aug", "histogram-xla", "histogram-pallas2"])
def test_three_bf16_steps_match_jax(variant, overrides):
    curves, deltas = bf16_steps(variant, 3, **overrides)
    for i, (ours, want) in enumerate(curves):
        for k in want:
            np.testing.assert_allclose(ours[k], want[k], rtol=BF16_LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    for name, (ours, want) in deltas.items():
        rel = np.linalg.norm(ours - want) / np.linalg.norm(want)
        assert rel <= BF16_DELTA_REL[name], (name, rel)
        assert np.linalg.norm(ours) > 0.5 * np.linalg.norm(want), name  # the port's step moved


def test_jax_cpu_default_moves_the_l1():
    """At step 0, from the same weights: with the JAX side on its CPU
    default ("auto": the XLA augmentation's float32 target) the L1 term
    reads ~1.2e-3 off the port's; with "pallas" (a compute-dtype target,
    as the port writes and the TPU kernel does) 1.4e-6."""
    rel = {}
    for jax_augment in ("auto", "pallas"):
        (ours, want), = bf16_steps("histogram", 1, jax_augment, histogram_impl="xla")[0]
        rel[jax_augment] = abs(ours["generator/l1_loss"] - want["generator/l1_loss"]) / abs(
            want["generator/l1_loss"])
    assert rel["pallas"] < 1e-5
    assert rel["auto"] > 5e-4
