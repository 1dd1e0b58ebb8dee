"""The port's closed RGBA training loops against the JAX step, and the TF
single-step fixtures no other port test reads.

* Six co-evolving steps of baseline-no-aug, of histogram under the
  default "xla"/"tri" and of histogram under "pallas2" (the port's plain
  version on CPU tensors, the JAX kernels in interpret mode), the port's
  `make_train_step` against the JAX `make_train_step`, from the parity
  weights (tests/parity_utils.py, drawn from each weight's canonical name)
  on the same seeded uint8 batches, with deterministic dropout and
  augment_probability 0, as tests/test_parity.py::TestTrajectoryParity
  sets them. The sprites that its TF fixtures need are not in the
  repository, so the JAX step is the reference here. Checked at that
  class's tolerances: every per-step loss (rtol 1e-3, adversarial 2e-3,
  Hellinger 1e-2), the step-2 parameter deltas at TIGHT_TOLS and the
  step-6 deltas at FINAL_TOLS (`_assert_grads_match` against the JAX
  deltas' norms, projections and small tensors). The loops run at the
  narrow widths (8 filters a stage) in the tier-1 suite: a full-width JAX
  step compiles for minutes on a CPU. One full-width loop, histogram
  "pallas2", is marked slow.
* The TF fixtures: `networks_grads_rgba.npz` (the baseline step's G and D
  gradients at full width, with tests/test_parity.py:257-294's checks),
  `losses.npz` (keras BCE and CCE, as tests/test_losses.py:20-35 reads
  it) and `networks_adam.npz` (`KerasAdam`, two steps on the generator's
  variables with synthetic gradients, as tests/test_parity.py:330-367).
"""

import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.models import convert as jconvert
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.train import losses as tl
from palette_and_histo_gan_tpu_torch.train import state as tstate
from palette_and_histo_gan_tpu_torch.train import steps as tsteps
from tests import parity_utils as pu
from tests.test_parity import (
    FINAL_TOLS,
    N_TIGHT_STEPS,
    N_TRAJ_STEPS,
    TIGHT_TOLS,
    TRAJ_BATCH,
    _assert_curve,
    _assert_grads_match,
    _run_production_trajectory,
)
from tests.test_torch_indexed import _d_to_tf, _g_to_tf
from tests.test_torch_networks import _torch_nets
from tests.test_torch_train_step import NARROW, configs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# per-step loss tolerances of TestTrajectoryParity
CURVES = (
    ("generator/total_loss", 1e-3),
    ("discriminator/total_loss", 1e-3),
    ("generator/adversarial_loss", 2e-3),
    ("generator/l1_loss", 1e-3),
)
LOOPS = {
    "baseline-no-aug": ("baseline-no-aug", {}),
    "histogram-xla": ("histogram", dict(histogram_impl="xla")),
    "histogram-pallas2": ("histogram", dict(histogram_impl="pallas2")),
}


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


def uint8_batches(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, (TRAJ_BATCH, 64, 64, 4), dtype=np.uint8) for _ in range(2))
            for _ in range(N_TRAJ_STEPS)]


def port_trajectory(config, g_tree, d_tree, batches):
    """The port's make_train_step N times from the trees: per-step metrics,
    the step-2 and the final (params - initial) deltas in TF layout."""
    state = tstate.create_train_state(config, "cpu", seed=0)
    convert.load_flax_params(state.generator, state.discriminator, g_tree, d_tree)
    g0 = {k: v.double() for k, v in state.generator.state_dict().items()}
    d0 = {k: v.double() for k, v in state.discriminator.state_dict().items()}

    def snapshot():
        return (
            _g_to_tf({k: v.double() - g0[k] for k, v in state.generator.state_dict().items()}),
            _d_to_tf({k: v.double() - d0[k] for k, v in state.discriminator.state_dict().items()}),
        )

    step = tsteps.make_train_step(config)
    curves, tight = [], None
    for i, (src, tgt) in enumerate(batches):
        metrics = step(state, torch.from_numpy(src), torch.from_numpy(tgt))
        curves.append({k: float(v) for k, v in metrics.items()})
        if i + 1 == N_TIGHT_STEPS:
            tight = snapshot()
    return curves, tight, snapshot()


def run_loop(monkeypatch, loop: str, widths: dict):
    variant, overrides = LOOPS[loop]
    jax_config, config = configs(variant, deterministic_dropout=True, augment_probability=0.0,
                                 donate_state=False, **overrides, **widths)
    batches = uint8_batches(11)
    with monkeypatch.context() as m:
        m.setattr(jconvert, "DOWN_FILTERS", tuple(config.down_filters))
        m.setattr(jconvert, "UP_FILTERS", tuple(config.up_filters))
        with pltpu.force_tpu_interpret_mode():
            want = _run_production_trajectory(jax_config, batches)
        g_tree, d_tree = pu.flax_generator_params(4, 4), pu.flax_discriminator_params(4)
    ours = port_trajectory(config, g_tree, d_tree, batches)

    (curves, tight, final), (want_curves, want_tight, want_final) = ours, want
    assert sorted(curves[0]) == sorted(want_curves[0])
    keys = CURVES + ((("generator/histogram_loss", 1e-2),) if variant == "histogram" else ())
    for key, rtol in keys:
        _assert_curve(curves, key, [c[key] for c in want_curves], rtol, key)
    for (got_g, got_d), (ref_g, ref_d), prefix, tols in (
        (tight, want_tight, "2.", TIGHT_TOLS), (final, want_final, ".", FINAL_TOLS),
    ):
        fixture = {**pu.grad_fixture_arrays(ref_g, "g" + prefix),
                   **pu.grad_fixture_arrays(ref_d, "d" + prefix)}
        _assert_grads_match(got_g, fixture, "g" + prefix, **tols)
        _assert_grads_match(got_d, fixture, "d" + prefix, **tols)
    return curves


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_narrow_closed_loop_matches_jax(loop, monkeypatch):
    curves = run_loop(monkeypatch, loop, NARROW)
    assert len(curves) == N_TRAJ_STEPS
    # the loop moved: the generator's loss is not where it started
    assert curves[-1]["generator/total_loss"] != curves[0]["generator/total_loss"]


@pytest.mark.slow
def test_full_width_histogram_pallas2_closed_loop_matches_jax(monkeypatch):
    # one summation order for the convolutions: with oneDNN's, one of the
    # 4,096 entries of gen/down0/conv has a step-1 gradient of 1.6e-6, in
    # Adam's eps band (|g| ~ eps / sqrt(1 - beta2) = 3.2e-6, where the
    # update scales with g), and the two frameworks' gradients there lie
    # 1.4e-6 apart (1e-5 of the tensor's largest, 0.139): the step-2 delta
    # misses TIGHT_TOLS' full-tensor pin at 0.24-0.29 of scale. Without
    # oneDNN they lie 6.6e-7 apart and the loop holds
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    run_loop(monkeypatch, "histogram-pallas2", {})


# ------------------------------------------------------------- TF fixtures


def test_rgba_step_gradients_match_tf():
    """The baseline step's G loss (BCE + 100 L1 through D) and D loss at
    full width from the parity weights, against the TF tape's gradients."""
    g = np.load(os.path.join(GOLDEN, "networks_rgba.npz"))
    gr = np.load(os.path.join(GOLDEN, "networks_grads_rgba.npz"))
    gen, disc = _torch_nets(config_for_variant("baseline-no-aug"),
                            pu.flax_generator_params(4, 4), pu.flax_discriminator_params(4))
    source, real = torch.from_numpy(g["source"]), torch.from_numpy(g["real"])

    fake = gen(source, deterministic=True)
    g_loss = tl.generator_loss(disc(fake, source), fake, real, 100.0)["total_loss"]
    names, params = zip(*gen.named_parameters())
    _assert_grads_match(_g_to_tf(dict(zip(names, torch.autograd.grad(g_loss, params)))), gr, "g.")

    fake = fake.detach()
    d_loss = tl.discriminator_loss(disc(real, source), disc(fake, source))["total_loss"]
    names, params = zip(*disc.named_parameters())
    _assert_grads_match(_d_to_tf(dict(zip(names, torch.autograd.grad(d_loss, params)))), gr, "d.")


def test_losses_match_keras():
    g = np.load(os.path.join(GOLDEN, "losses.npz"))
    logits = torch.from_numpy(g["logits"])
    np.testing.assert_allclose(float(tl.bce_with_logits(torch.ones_like(logits), logits)),
                               g["bce_ones"], rtol=1e-5)
    np.testing.assert_allclose(float(tl.bce_with_logits(torch.zeros_like(logits), logits)),
                               g["bce_zeros"], rtol=1e-5)
    cce = tl.categorical_crossentropy_probs(torch.from_numpy(g["onehot"]),
                                            torch.from_numpy(g["probs"]))
    np.testing.assert_allclose(float(cce), g["cce"], rtol=1e-5)


def test_keras_adam_matches_keras():
    """`KerasAdam` (the port's optimizer at the configuration's settings)
    against keras Adam(2e-4, beta_1=0.5, eps 1e-7): two steps with
    different synthetic gradients over the generator's variables (t=1 and
    t=2 bias corrections, the moments mixed), the updates against the
    fixture's. Adam is elementwise, so the variables keep their TF layouts."""
    ad = np.load(os.path.join(GOLDEN, "networks_adam.npz"))
    config = config_for_variant("baseline-no-aug")
    w = pu.materialize(pu.generator_param_spec(4, 4))
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w.items()}
    opt = tstate.KerasAdam(list(params.values()), lr=config.learning_rate,
                           betas=(config.beta1, config.beta2), eps=config.adam_eps)
    for tag, prefix in (("#adam_g1", "s1."), ("#adam_g2", "s2.")):
        before = {k: p.detach().clone() for k, p in params.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(pu.make_param(k + tag, p.shape, "conv"))
        opt.step()
        updates = {k: (p.detach().double() - before[k].double()).numpy()
                   for k, p in params.items()}
        _assert_grads_match(updates, ad, prefix)
