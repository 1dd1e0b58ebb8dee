"""The components that `palette_and_histo_gan_tpu_torch/profile_components.py`
times compute what the step computes, at narrow widths on the CPU:

* `hist_fwd_bwd`'s gradient equals autograd of the step's histogram loss
  (both histograms and the Hellinger loss, with respect to the fake) on the
  plain path, under "xla" and under "pallas2" (the kernels' plain versions
  on CPU tensors);
* `adam_updates` on zero gradients equals one `KerasAdam.step` of each
  network on zero gradients, from moments that an earlier step made;
* `g_fwd_no_dropout` equals the deterministic generator, the exported
  program's forward.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu_torch import profile_components as pc
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.models.export import GeneratorInference
from palette_and_histo_gan_tpu_torch.ops import histogram as hist_ops
from palette_and_histo_gan_tpu_torch.ops.histogram_pallas2 import (
    calculate_rgbuv_histogram_pallas2)
from palette_and_histo_gan_tpu_torch.train.state import create_train_state

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def setup(histogram_impl="xla", seed=0):
    config = config_for_variant("histogram", batch_size=2, histogram_impl=histogram_impl,
                                **NARROW)
    state = create_train_state(config, "cpu", seed)
    data = pc.inputs(2, "cpu")
    return config, state, data, pc.components(config, state, data)


@pytest.mark.parametrize("impl", ["xla", "pallas2"])
def test_hist_fwd_bwd_is_the_step_histogram_gradient(impl):
    config, _, data, calls = setup(impl)
    got = calls["hist_fwd_bwd"]()
    hist = (calculate_rgbuv_histogram_pallas2 if impl == "pallas2"
            else lambda x, **kw: hist_ops.calculate_rgbuv_histogram(x, bwd="tri", **kw))
    kw = dict(size=config.histogram_size, method=config.histogram_method,
              sigma=config.histogram_sigma, dtype=torch.float32)
    fake = data["src"].clone().requires_grad_(True)
    loss = hist_ops.hellinger_loss(hist(data["tgt"], **kw), hist(fake, **kw))
    (want,) = torch.autograd.grad(loss, fake)
    assert got.shape == (2, 64, 64, 4) and float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_adam_updates_is_one_keras_adam_step_on_zero_gradients():
    _, ours, _, calls = setup()
    _, ref, _, _ = setup()
    for state in (ours, ref):  # moments from one step on the same gradients
        for module, optimizer in ((state.generator, state.g_optimizer),
                                  (state.discriminator, state.d_optimizer)):
            g = np.random.default_rng(3)
            for p in module.parameters():
                p.grad = torch.from_numpy(g.standard_normal(p.shape).astype(np.float32))
            optimizer.step()
    calls["adam_updates"]()
    for module, optimizer in ((ref.generator, ref.g_optimizer),
                              (ref.discriminator, ref.d_optimizer)):
        for p in module.parameters():
            p.grad = torch.zeros_like(p)
        optimizer.step()
    for a, b in ((ours.generator, ref.generator), (ours.discriminator, ref.discriminator)):
        for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(x, y), name
    moved = [not torch.equal(x, y) for x, y in
             zip(ours.generator.parameters(), setup()[1].generator.parameters())]
    assert any(moved)


def test_g_fwd_no_dropout_is_the_deterministic_generator():
    _, state, data, calls = setup()
    got = calls["g_fwd_no_dropout"]()
    with torch.no_grad():
        want = GeneratorInference(state.generator)(data["src"]).sum()
    assert torch.equal(got, want)
    assert torch.equal(calls["g_fwd_no_dropout"](), got)
    assert not torch.equal(calls["g_fwd_dropout"](), got)


def test_component_names_are_the_scripts():
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "profile_components.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {node.args[0].value for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "report"
             and isinstance(node.args[0], ast.Constant)}
    # the script's f-string row is its alternative transpose_impl, a TPU lowering
    assert names == set(pc.COMPONENTS)
    assert set(setup()[3]) == set(pc.COMPONENTS)
