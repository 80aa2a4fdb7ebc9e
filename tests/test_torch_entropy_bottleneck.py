"""Port entropy bottleneck and core math against the JAX package.

Tolerances are tests/test_pallas_eb.py's: rtol 1e-5 on values, 1e-4 on
gradients (the same fp32 chain; only the batched-matmul summation order and
the transcendental implementations differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.coding import entropy_bottleneck as jeb
from lossyless_tpu.core import math as jmath
from lossyless_tpu_torch.coding import entropy_bottleneck as teb
from lossyless_tpu_torch.core import math as tmath
from tests.test_torch_coding import random_eb_params

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
C = 16


@pytest.fixture(scope="module")
def params():
    return random_eb_params(7, channels=C)


def _t(p, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}


def _z(seed, batch=9):
    return np.random.default_rng(seed).normal(0, 3, (batch, C)).astype(
        np.float32)


def test_likelihood_matches(params):
    z = _z(0)
    want = np.asarray(jeb.likelihood(params, jnp.asarray(z)))
    got = teb.likelihood(_t(params), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_likelihood_gradients_match(params):
    z = _z(1)

    # the log of the floored likelihood, as the rate loss takes it
    def jloss(p, zz):
        lik = jmath.lower_bound(jeb.likelihood(p, zz), jeb.LIKELIHOOD_BOUND)
        return jnp.sum(jnp.log(lik))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_p, want_z = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(z))
    tp = _t(params, grad=True)
    tz = torch.tensor(z, requires_grad=True)
    lik = tmath.lower_bound(teb.likelihood(tp, tz), teb.LIKELIHOOD_BOUND)
    torch.log(lik).sum().backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_z), **GRAD)
    for k in params:
        if k == "quantiles":
            assert tp[k].grad is None
            continue
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_p[k]),
                                   err_msg=k, **GRAD)


@pytest.mark.parametrize("mode", ["noise", "dequantize", "symbols"])
def test_quantize_matches(params, mode):
    z = _z(2)
    key = jax.random.key(3)
    want = np.asarray(jeb.quantize(params, jnp.asarray(z), mode, key))
    noise = None
    if mode == "noise":   # the very draws JAX's quantize makes from `key`
        noise = torch.tensor(np.asarray(jax.random.uniform(
            key, z.shape, jnp.float32, -0.5, 0.5)))
    got = teb.quantize(_t(params), torch.from_numpy(z), mode, noise).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_forward_eval_matches(params):
    z = _z(4)
    jz, jl = jeb.forward(params, jnp.asarray(z), training=False)
    tz, tl = teb.forward(_t(params), torch.from_numpy(z), training=False)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **VAL)
    assert float(tl.min()) >= np.float32(teb.LIKELIHOOD_BOUND)


def test_forward_training_noise_and_likelihood(params):
    """Training mode: noise from the generator, then JAX's likelihood of
    the same noisy values (the draws themselves differ between RNGs)."""
    z = _z(5)
    tz, tl = teb.forward(_t(params), torch.from_numpy(z), training=True,
                         generator=torch.Generator().manual_seed(0))
    noise = tz.numpy() - z
    assert np.all(np.abs(noise) <= 0.5 + 1e-6) and np.std(noise) > 0.1
    _, again = teb.forward(_t(params), torch.from_numpy(z), training=True,
                           generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, tl, rtol=0, atol=0)
    want = jmath.lower_bound(jeb.likelihood(params, jnp.asarray(tz.numpy())),
                             jeb.LIKELIHOOD_BOUND)
    np.testing.assert_allclose(tl.numpy(), np.asarray(want), **VAL)


def test_aux_loss_and_its_gradient_match(params):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, want_g = jax.value_and_grad(jeb.aux_loss)(jp)
    tp = _t(params, grad=True)
    got = teb.aux_loss(tp)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tp["quantiles"].grad.numpy(),
                               np.asarray(want_g["quantiles"]), **GRAD)
    for k in params:   # only the quantiles train on the aux loss
        if k != "quantiles":
            assert tp[k].grad is None


def test_init_params_layout(params):
    g = torch.Generator().manual_seed(0)
    got = teb.init_params(teb.EBConfig(C), g)
    want = jeb.init_params(jeb.EBConfig(C), jax.random.key(0))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if not k.startswith("bias"):   # the deterministic entries
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            assert float(got[k].abs().max()) <= 0.5
    again = teb.init_params(teb.EBConfig(C), torch.Generator().manual_seed(0))
    assert torch.equal(again["bias0"], got["bias0"])
    np.testing.assert_array_equal(teb.medians(got).numpy(),
                                  np.asarray(jeb.medians(want)))


def test_lower_bound_gradient_semantics():
    x = np.array([-1.0, 0.5, 2.0, 0.0, 3.0, -2.0], np.float32)
    g = np.array([1.0, 1.0, -1.0, -1.0, 1.0, -1.0], np.float32)
    bound = 0.5
    want = jax.vjp(lambda t: jmath.lower_bound(t, bound), jnp.asarray(x))[1](
        jnp.asarray(g))[0]
    tx = torch.tensor(x, requires_grad=True)
    y = tmath.lower_bound(tx, bound)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, bound))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    # passes where x >= bound or g < 0, else blocked
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.where((x >= bound) | (g < 0), g, 0))


def test_ste_round_rounds_half_to_even_with_identity_gradient():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 2.51], np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = tmath.ste_round(tx)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jmath.ste_round(jnp.asarray(x))))
    y.backward(torch.arange(7.0))
    np.testing.assert_array_equal(tx.grad.numpy(), np.arange(7.0))
