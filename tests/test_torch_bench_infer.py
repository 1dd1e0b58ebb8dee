"""The port's serving benchmark (`palette_and_histo_gan_tpu_torch/
bench_infer.py`) measures the serving program, as tests/test_bench_infer.py
holds the JAX script's to it, at narrow widths on the CPU:

* with dropout on, the chunk's checksum equals direct
  `train/steps.py::generate` calls over the same rotating batches with the
  same dropout draws (RGBA and indexed), rtol 1e-4: the same ops and draws,
  only the order of the checksum's additions differs;
* with `--deterministic`, the chunk equals `scripts/bench_infer.
  make_infer_chunk(..., deterministic=True)` on the same pool and the JAX
  weights carried across by `models/convert.py::
  generator_state_dict_from_flax` (RGBA and indexed), rtol 1e-4, the JAX
  test's tolerance.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from palette_and_histo_gan_tpu.config import config_for_variant as jax_config_for_variant
from palette_and_histo_gan_tpu.train.state import build_models, create_train_state
from palette_and_histo_gan_tpu_torch import bench_infer
from palette_and_histo_gan_tpu_torch.config import config_for_variant
from palette_and_histo_gan_tpu_torch.models import convert
from palette_and_histo_gan_tpu_torch.models.networks import build_generator
from palette_and_histo_gan_tpu_torch.train.steps import generate

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

NARROW = dict(down_filters=(8,) * 6, up_filters=(8,) * 6)
N_DATA = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def direct_batch(config, pool: torch.Tensor, i: int) -> torch.Tensor:
    """The script's gather and normalize, written out."""
    idx = (torch.arange(config.batch_size) + i * 8191) % pool.shape[0]
    src = pool[idx]
    return src if config.is_indexed else src.float() / 127.5 - 1.0


@pytest.mark.parametrize("variant", ["baseline-no-aug", "indexed"])
def test_chunk_equals_direct_generate_with_dropout(variant):
    config, generator, _ = bench_infer.setup(variant, 4, "float32", "cpu", **NARROW)
    pool = bench_infer.make_pool(config, N_DATA, "cpu")
    chunk = bench_infer.make_infer_chunk(config, generator, pool)
    steps = 3
    got = float(chunk(bench_infer.dropout_generator("cpu"), steps))
    drop = bench_infer.dropout_generator("cpu")
    want = sum(float(generate(config, generator, direct_batch(config, pool, i), drop).float().sum())
               for i in range(steps))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # dropout is on: the deterministic program serves other outputs
    det = bench_infer.make_infer_chunk(config, generator, pool, deterministic=True)
    assert float(det(bench_infer.dropout_generator("cpu"), steps)) != got


@pytest.mark.parametrize("variant", ["baseline-no-aug", "indexed"])
def test_deterministic_chunk_equals_the_jax_script(variant):
    import bench_infer as script

    kw = dict(batch_size=4, donate_state=False, **NARROW)
    jax_config = jax_config_for_variant(variant, **kw)
    models = build_models(jax_config)
    state = create_train_state(jax_config, models, jax.random.PRNGKey(0))
    config = config_for_variant(variant, **kw)
    pool = bench_infer.make_pool(config, N_DATA, "cpu")
    jax_chunk = script.make_infer_chunk(jax_config, models, N_DATA, deterministic=True)
    want = float(jax_chunk(state.g_params, jnp.asarray(pool.numpy()), jax.random.PRNGKey(1),
                           num_steps=2))

    generator = build_generator(config, torch.float32)
    generator.load_state_dict(convert.generator_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.g_params), generator))
    chunk = bench_infer.make_infer_chunk(config, generator, pool, deterministic=True)
    got = float(chunk(bench_infer.dropout_generator("cpu"), 2))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cpu_row_is_on_the_host_clock():
    row = bench_infer.run("baseline-no-aug", 4, 2, "float32", True, "cpu", **NARROW)
    assert row["clock"] == "host" and row["mfu"] is None
    assert row["ms_per_batch"] == row["host_ms_per_batch"] > 0
    assert row["dropout"] == "off (exported-program semantics)"
    assert row["infer_head_conv"] == "train" and np.isfinite(row["checksum"])
