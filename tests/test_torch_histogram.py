"""The PyTorch port's RGB-uv histogram against the JAX package's.

Forward values and input gradients of palette_and_histo_gan_tpu_torch/ops/
histogram.py::calculate_rgbuv_histogram are held against
calculate_rgbuv_histogram(..., bwd="tri") on the same numpy inputs.

Float32 tolerances, relative to the largest |value| of the tensor compared:
  * 3e-5 with each side's own bin centres. jnp.linspace's float32 centres
    differ from the correctly rounded ones the port uses by one ulp
    (2.4e-7 at 3.0) at 52 of the 64 bins, and with sigma = 0.02 the kernel
    moves by up to ~1e-5 relative for such a shift;
  * 5e-6 once the port is given JAX's exact centres: what remains is
    summation order.
The bfloat16 chain is checked loosely (5e-3 forward, 2e-2 gradient): both
sides round the same chain to bfloat16 at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palette_and_histo_gan_tpu.ops import histogram as jh
from palette_and_histo_gan_tpu_torch.ops import histogram as th


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (2, 64, 64, 4)).astype(np.float32)
    w = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    return x, w


def _jax(x, w, dtype):
    def f(a):
        return jh.calculate_rgbuv_histogram(a, dtype=dtype, bwd="tri")

    hist = f(jnp.asarray(x))
    grad = jax.grad(lambda a: jnp.sum(f(a) * w))(jnp.asarray(x))
    return np.asarray(hist), np.asarray(grad)


def _torch(x, w, dtype):
    xt = torch.from_numpy(x).requires_grad_()
    hist = th.calculate_rgbuv_histogram(xt, dtype=dtype)
    (hist * torch.from_numpy(w)).sum().backward()
    return hist.detach().numpy(), xt.grad.numpy()


def _assert_close_to_max(a, b, tol):
    err = np.max(np.abs(a - b)) / np.max(np.abs(b))
    assert err <= tol, err


@pytest.mark.parametrize("jax_domain", [False, True])
def test_float32_forward_and_gradient(monkeypatch, jax_domain):
    if jax_domain:
        centres = torch.from_numpy(np.array(jnp.linspace(-3.0, 3.0, num=64)))
        monkeypatch.setattr(
            th, "_domain", lambda size, dtype, device: centres.to(dtype)[None, :]
        )
    tol = 5e-6 if jax_domain else 3e-5
    x, w = _inputs()
    hist_j, grad_j = _jax(x, w, jnp.float32)
    hist_t, grad_t = _torch(x, w, torch.float32)
    assert hist_t.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(hist_t.sum(axis=(1, 2, 3)), 1.0, rtol=1e-5)
    _assert_close_to_max(hist_t, hist_j, tol)
    _assert_close_to_max(grad_t, grad_j, tol)


def test_bfloat16_chain():
    x, w = _inputs(1)
    hist_j, grad_j = _jax(x, w, jnp.bfloat16)
    hist_t, grad_t = _torch(x, w, torch.bfloat16)
    assert hist_t.dtype == np.float32
    _assert_close_to_max(hist_t, hist_j, 5e-3)
    _assert_close_to_max(grad_t, grad_j, 2e-2)


def test_hellinger_and_l1_losses():
    x, _ = _inputs(2)
    h1 = np.array(jh.calculate_rgbuv_histogram(jnp.asarray(x)))
    h2 = np.array(jh.calculate_rgbuv_histogram(jnp.asarray(x[::-1].copy())))
    np.testing.assert_allclose(
        float(th.hellinger_loss(torch.from_numpy(h1), torch.from_numpy(h2))),
        float(jh.hellinger_loss(jnp.asarray(h1), jnp.asarray(h2))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(th.l1_loss(torch.from_numpy(h1), torch.from_numpy(h2))),
        float(jh.l1_loss(jnp.asarray(h1), jnp.asarray(h2))),
        rtol=1e-6,
    )
