"""The port's fused-histogram paths against the JAX package's Pallas kernels.

The CUDA kernels (csrc/histogram.cu) run only on the card; here the CPU
tensors take their plain versions (ops/histogram_kernel.py), which compute
the kernels' algorithm with the same roundings. They are held against the
JAX kernels K3a/K4a (histogram_pallas.py), K3b/K4b (histogram_pallas2.py)
and K4c (histogram_pallas3.py, also through calculate_rgbuv_histogram(...,
bwd="pallas")), run in Pallas interpret mode, on the same numpy inputs.

Tolerances, as a fraction of the largest |value| compared:
  * forward, float32: rtol 1e-4, atol 1e-6, the JAX package's own
    (tests/test_histogram_pallas.py): both sides take the TPU kernels' bin
    centres, so what remains is summation order and x^2 / s^2 against
    x^2 * (1 / s^2);
  * forward, bfloat16 chain: 5e-3; both sides round the same chain to
    bfloat16, but XLA on the CPU keeps float32 between fused bfloat16
    operations (xla_allow_excess_precision), so the JAX side rounds fewer
    intermediates than the kernel does;
  * backward on the same cotangent: 1e-4 in float32 (the port runs K4c's
    algebra for all three backwards, so against K4a and K4b this is also
    the algebra's reassociation; measured <= 2.5e-5) and 1e-2 in bfloat16
    (the excess precision above, and against K4b its algebra's other
    rounding points; measured <= 6.1e-3). With the excess precision turned
    off on the JAX side, K4c's bfloat16 backward agrees to 1e-5 (measured
    ~1e-7): the plain version rounds where the TPU kernel rounds;
  * gradients through a Hellinger loss: 1e-4 in float32, as the JAX
    package holds K4c to its "tri" backward (tests/test_histogram_pallas.py:
    155), and 2e-2 in bfloat16, as tests/test_torch_histogram.py holds the
    bfloat16 chain: the forward's bfloat16 roundings move the loss's
    cotangent too;
  * the alpha channel's gradient is exactly 0.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from palette_and_histo_gan_tpu.ops import histogram as jh
from palette_and_histo_gan_tpu.ops import histogram_pallas as jp1
from palette_and_histo_gan_tpu.ops import histogram_pallas2 as jp2
from palette_and_histo_gan_tpu.ops import histogram_pallas3 as jp3
from palette_and_histo_gan_tpu_torch import check_supported, config_for_variant
from palette_and_histo_gan_tpu_torch.ops import histogram as th
from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk
from palette_and_histo_gan_tpu_torch.ops import histogram_pallas as tp1
from palette_and_histo_gan_tpu_torch.ops import histogram_pallas2 as tp2
from palette_and_histo_gan_tpu_torch.ops import histogram_pallas3 as tp3
from palette_and_histo_gan_tpu_torch.train import steps as tsteps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


# impl -> (port function, JAX function), each called as f(x, size, method, dtype)
IMPLS = {
    "pallas": (
        lambda x, size, method, dtype: tp1.calculate_rgbuv_histogram_pallas(
            x, size=size, method=method
        ),
        lambda x, size, method, dtype: jp1.calculate_rgbuv_histogram_pallas(
            x, size=size, method=method
        ),
    ),
    "pallas2": (
        lambda x, size, method, dtype: tp2.calculate_rgbuv_histogram_pallas2(
            x, size=size, method=method, dtype=dtype
        ),
        lambda x, size, method, dtype: jp2.calculate_rgbuv_histogram_pallas2(
            x, size=size, method=method, dtype=JAX_DTYPES[dtype]
        ),
    ),
    "bwd-pallas": (
        lambda x, size, method, dtype: th.calculate_rgbuv_histogram(
            x, size=size, method=method, dtype=dtype, bwd="pallas"
        ),
        lambda x, size, method, dtype: jh.calculate_rgbuv_histogram(
            x, size=size, method=method, dtype=JAX_DTYPES[dtype], bwd="pallas"
        ),
    ),
}


def _rel_to_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("method", ["inverse-quadratic", "RBF"])
@pytest.mark.parametrize("size,side", [(16, 8), (64, 16)])
@pytest.mark.parametrize(
    "impl,dtype",
    [("pallas", torch.float32), ("pallas2", torch.float32), ("pallas2", torch.bfloat16)],
)
def test_plain_forward_matches_jax_kernel(impl, dtype, size, side, method):
    rng = np.random.default_rng(size + side)
    x = rng.uniform(-1, 1, (2, side, side, 4)).astype(np.float32)
    ours_fn, ref_fn = IMPLS[impl]
    ours = ours_fn(torch.from_numpy(x), size, method, dtype).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(x), size, method, dtype))
    assert ours.shape == ref.shape == (2, size, size, 3)
    if dtype == torch.float32:
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    else:
        assert _rel_to_max(ours, ref) <= 5e-3


def _hellinger_grads(fn, batch, target, *, framework):
    if framework == "jax":
        t = jnp.asarray(target)
        return np.asarray(jax.grad(lambda a: jh.hellinger_loss(fn(t), fn(a)))(jnp.asarray(batch)))
    xt = torch.from_numpy(batch).requires_grad_()
    th.hellinger_loss(fn(torch.from_numpy(target)), fn(xt)).backward()
    return xt.grad.numpy()


@pytest.mark.parametrize(
    "impl,dtype,method,batch",
    [
        ("pallas", torch.float32, "inverse-quadratic", 3),
        ("pallas2", torch.float32, "inverse-quadratic", 3),
        ("pallas2", torch.bfloat16, "inverse-quadratic", 3),
        # batch 8 takes K4c's block-8 path, batch 3 its block-1 path
        ("bwd-pallas", torch.float32, "inverse-quadratic", 8),
        ("bwd-pallas", torch.float32, "inverse-quadratic", 3),
        ("bwd-pallas", torch.bfloat16, "inverse-quadratic", 8),
        ("bwd-pallas", torch.bfloat16, "inverse-quadratic", 3),
        ("bwd-pallas", torch.float32, "RBF", 8),
    ],
)
def test_plain_gradient_matches_jax_kernel(impl, dtype, method, batch):
    rng = np.random.default_rng(10 + batch)
    x = rng.uniform(-0.9, 0.9, (batch, 8, 8, 4)).astype(np.float32)
    target = rng.uniform(-0.9, 0.9, (batch, 8, 8, 4)).astype(np.float32)
    ours_fn, ref_fn = IMPLS[impl]
    ours = _hellinger_grads(lambda a: ours_fn(a, 16, method, dtype), x, target, framework="torch")
    ref = _hellinger_grads(lambda a: ref_fn(a, 16, method, dtype), x, target, framework="jax")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(ours, ref, atol=tol * np.abs(ref).max(), rtol=0)
    assert np.abs(ours[..., 3]).max() == 0.0


SIGMA = 0.02


def _backward_inputs(batch, seed, size=16):
    """Pixels (B, HW, 3) in (0, 1) and a cotangent (B, 3, size, size)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.02, 0.98, (batch, 64, 3)).astype(np.float32)
    g = (rng.standard_normal((batch, 3, size, size)) * 1e-2).astype(np.float32)
    return x, g


def _port_backward(kernel, x, g, method, dtype):
    flat01, g_cm = torch.from_numpy(x), torch.from_numpy(g)
    size = g.shape[-1]
    if kernel == "K4c":
        return tp3.backward_unnormalized_pallas3(
            flat01, g_cm.movedim(1, -1), size, method, SIGMA, dtype
        ).numpy()
    logs, iy = hk.logs_and_intensity(flat01)
    rows = hk.histogram_backward(
        logs, iy, g_cm, size=size, method=method, sigma=SIGMA, chain=dtype,
        approx=False, kernel=kernel,
    )
    return hk.finish(rows, flat01, iy).numpy()


def _jax_backward(kernel, x, g, method, dtype):
    size = g.shape[-1]
    if kernel == "K4a":
        out = jp1._backward_unnormalized(jnp.asarray(x), jnp.asarray(g), size, method, SIGMA)
    elif kernel == "K4b":
        (out,) = jp2._hist2_core_bwd(
            size, method, SIGMA, JAX_DTYPES[dtype], jnp.asarray(x), jnp.asarray(g)
        )
    else:
        out = jp3.backward_unnormalized_pallas3(
            jnp.asarray(x), jnp.moveaxis(jnp.asarray(g), 1, -1), size, method, SIGMA,
            dtype=JAX_DTYPES[dtype],
        )
    return np.asarray(out)


@pytest.mark.parametrize("method", ["inverse-quadratic", "RBF"])
@pytest.mark.parametrize(
    "kernel,dtype,batch",
    [
        ("K4a", torch.float32, 3),
        ("K4b", torch.float32, 3),
        ("K4b", torch.bfloat16, 3),
        # batch 8 takes K4c's block-8 path, batch 3 its block-1 path
        ("K4c", torch.float32, 8),
        ("K4c", torch.float32, 3),
        ("K4c", torch.bfloat16, 8),
        ("K4c", torch.bfloat16, 3),
    ],
)
def test_plain_backward_matches_jax_kernel(kernel, dtype, batch, method):
    x, g = _backward_inputs(batch, batch)
    ours = _port_backward(kernel, x, g, method, dtype)
    ref = _jax_backward(kernel, x, g, method, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(ours, ref, atol=tol * np.abs(ref).max(), rtol=0)


_EXACT_K4C = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu
from palette_and_histo_gan_tpu.ops import histogram_pallas3 as jp3

inputs = np.load(sys.argv[1])
out = {}
with pltpu.force_tpu_interpret_mode():
    for key in inputs.files:
        if key.startswith("x-"):
            case = key[2:]
            out[case] = np.asarray(jp3.backward_unnormalized_pallas3(
                jnp.asarray(inputs[key]), jnp.moveaxis(jnp.asarray(inputs["g-" + case]), 1, -1),
                16, case.split(":")[0], float(inputs["sigma"]), dtype=jnp.bfloat16,
            ))
np.savez(sys.argv[2], **out)
"""
CASES = [(m, b) for m in ("inverse-quadratic", "RBF") for b in (8, 3)]


@pytest.fixture(scope="module")
def jax_k4c_bf16_rounded_each_op(tmp_path_factory):
    """JAX K4c's bfloat16 backward with XLA's excess precision off, so that
    every bfloat16 operation rounds, as the TPU kernel's arithmetic does:
    a process of its own, since the flag is read when the CPU backend
    starts."""
    folder = tmp_path_factory.mktemp("k4c")
    inputs = {"sigma": np.float32(SIGMA)}
    for method, batch in CASES:
        x, g = _backward_inputs(batch, batch)
        inputs[f"x-{method}:{batch}"], inputs[f"g-{method}:{batch}"] = x, g
    np.savez(folder / "in.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-c", _EXACT_K4C, str(folder / "in.npz"), str(folder / "out.npz")],
        cwd=REPO, env=env, check=True, capture_output=True, timeout=300,
    )
    return dict(np.load(folder / "out.npz"))


@pytest.mark.parametrize("method,batch", CASES)
def test_plain_k4c_bfloat16_rounds_where_the_tpu_kernel_rounds(
    jax_k4c_bf16_rounded_each_op, method, batch
):
    x, g = _backward_inputs(batch, batch)
    ours = _port_backward("K4c", x, g, method, torch.bfloat16)
    ref = jax_k4c_bf16_rounded_each_op[f"{method}:{batch}"]
    np.testing.assert_allclose(ours, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_bin_centres_are_the_tpu_kernels():
    """The kernels' centres -3 + i * (6 / 63) in float32, not jnp.linspace's
    (one float32 ulp apart at most bins)."""
    ours = hk.domain(64, "cpu").numpy()
    np.testing.assert_array_equal(ours, np.asarray(jp2._domain_col(64))[:, 0])
    assert np.sum(ours != np.asarray(jnp.linspace(-3.0, 3.0, 64))) > 0


def test_cpu_tensors_take_the_plain_versions():
    hk.reset_launches()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 8, 8, 4)).astype(np.float32))
    x.requires_grad_()
    for impl, dtype in (("pallas", torch.float32), ("pallas2", torch.bfloat16),
                        ("bwd-pallas", torch.bfloat16)):
        IMPLS[impl][0](x, 64, "inverse-quadratic", dtype).square().sum().backward()
    assert all(n == 0 for n in hk.launches.values()), hk.launches
    assert sorted(hk.launches) == ["K3a", "K3b", "K4a", "K4b", "K4c"]


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    logs = torch.zeros(2, 3, 4096)
    iy = torch.ones(2, 4096)
    kw = dict(size=64, method="inverse-quadratic", sigma=0.02, chain=torch.float32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        hk.histogram_forward_cuda(logs, iy, kernel="K3a", **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        hk.histogram_backward_cuda(
            logs, iy, torch.zeros(2, 3, 64, 64), approx=False, kernel="K4c", **kw
        )
    with pytest.raises(ValueError, match="64 bins"):
        hk.histogram_forward_cuda(logs, iy, kernel="K3a", **dict(kw, size=16))
    with pytest.raises(ValueError, match="kernel must be one of"):
        hk.histogram_forward(logs, iy, kernel="K4a", **kw)
    assert hk.histogram_forward(logs, iy, kernel="K3a", **kw).shape == (2, 3, 64, 64)


@pytest.mark.parametrize(
    "impl,bwd", [("pallas", "tri"), ("pallas2", "tri"), ("xla", "pallas"),
                 ("pallas", "dual"), ("pallas2", "tri2c")]
)
def test_check_supported_accepts_the_kernel_configurations(impl, bwd):
    """histogram_bwd counts only under "xla", as in the JAX step."""
    config = config_for_variant("histogram", histogram_impl=impl, histogram_bwd=bwd)
    check_supported(config, "cpu")
    check_supported(config, "cuda")


@pytest.mark.parametrize("bwd", ["dual", "tri2", "tri2b", "tri2c"])
def test_check_supported_rejects_xla_backward_variants(bwd):
    config = config_for_variant("histogram", histogram_bwd=bwd)
    with pytest.raises(NotImplementedError, match="dot-structure"):
        check_supported(config, "cpu")


def test_step_dispatch_follows_the_jax_step():
    """"pallas" drops the dtype (its chain is float32); histogram_bwd counts
    only under "xla"."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 4)).astype(np.float32))
    kw = dict(size=16, method="inverse-quadratic", sigma=0.02)

    def via_step(impl, bwd, dtype):
        config = config_for_variant("histogram", histogram_impl=impl, histogram_bwd=bwd)
        return tsteps.histogram_fn(config)(x, dtype=dtype, **kw)

    torch.testing.assert_close(
        via_step("pallas", "tri", torch.bfloat16),
        tp1.calculate_rgbuv_histogram_pallas(x, **kw), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        via_step("pallas2", "dual", torch.bfloat16),
        tp2.calculate_rgbuv_histogram_pallas2(x, dtype=torch.bfloat16, **kw), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        via_step("xla", "pallas", torch.float32),
        th.calculate_rgbuv_histogram(x, dtype=torch.float32, bwd="pallas", **kw), rtol=0, atol=0,
    )
