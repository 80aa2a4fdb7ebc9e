"""Port attention (K1, K2) against the JAX Pallas kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attn.py does. The port's wrappers route CPU tensors to
their plain versions (the CUDA kernels' arithmetic in plain torch), so this
holds that arithmetic — q.k in fp32 scaled after the dot, fp32 softmax,
probabilities cast to the io dtype before an fp32 P.V — to the TPU kernels.

Tolerances are test_flash_attn.py's: 1e-5 in fp32 (summation order only),
atol 2e-2 in bf16 (one bf16 rounding of the probabilities and output);
gradients rtol 1e-5 / atol 1e-6 (both backwards recompute in fp32; the JAX
one through its einsum reference, which scales q before the dot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import flash_attn as jfa
from lossyless_tpu_torch.nn import flash_attn as tfa

D, HEADS = 96, 4
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(atol=2e-2)


def _qkv(B, N, seed=0):
    return np.random.default_rng(seed).normal(size=(B, N, 3 * D)).astype(
        np.float32)


def _jax(x, dtype):
    return jnp.asarray(x, jnp.float32 if dtype == torch.float32
                       else jnp.bfloat16)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


@jax.jit
def _jax_k1(qkv):
    return jfa.fused_attention(qkv, HEADS, True)


@jax.jit
def _jax_k2(q0, kv):
    return jfa.fused_attention_cls(q0, kv, HEADS, True)


@pytest.mark.parametrize("N", [5, 10, 50])
@pytest.mark.parametrize("B", [1, 3, 7, 8])
def test_plain_matches_pallas_fp32(B, N):
    x = _qkv(B, N, seed=B * 100 + N)
    qkv = torch.from_numpy(x)
    got1 = tfa.fused_attention(qkv, HEADS)
    np.testing.assert_allclose(_np(got1), _np(_jax_k1(jnp.asarray(x))),
                               **FP32)
    q0, kv = x[:, :1, :D], x[:, :, D:]
    got2 = tfa.fused_attention_cls(torch.from_numpy(q0.copy()),
                                   torch.from_numpy(kv.copy()), HEADS)
    np.testing.assert_allclose(
        _np(got2), _np(_jax_k2(jnp.asarray(q0), jnp.asarray(kv))), **FP32)
    # K2 is K1's token-0 row
    np.testing.assert_allclose(_np(got2), _np(got1[:, :1]), **FP32)


@pytest.mark.parametrize("B,N", [(1, 5), (3, 10), (7, 50), (8, 50)])
def test_plain_matches_pallas_bf16(B, N):
    x = _qkv(B, N, seed=7)
    qkv = torch.from_numpy(x).to(torch.bfloat16)
    got1 = tfa.fused_attention(qkv, HEADS)
    assert got1.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got1), _np(_jax_k1(_jax(x, torch.bfloat16))), **BF16)
    q0, kv = qkv[:, :1, :D].contiguous(), qkv[:, :, D:].contiguous()
    got2 = tfa.fused_attention_cls(q0, kv, HEADS)
    want2 = _jax_k2(_jax(x[:, :1, :D], torch.bfloat16),
                    _jax(x[:, :, D:], torch.bfloat16))
    np.testing.assert_allclose(_np(got2), _np(want2), **BF16)


def test_k1_gradient_matches_jax():
    x = _qkv(3, 10, seed=11)
    g = np.random.default_rng(12).normal(size=(3, 10, D)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jfa.fused_attention(t, HEADS, True)
                                      * g))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (tfa.fused_attention(t, HEADS) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_k2_gradient_matches_jax():
    x = _qkv(3, 10, seed=13)
    q0, kv = x[:, :1, :D].copy(), x[:, :, D:].copy()
    g = np.random.default_rng(14).normal(size=(3, 1, D)).astype(np.float32)
    want_q, want_kv = jax.grad(
        lambda a, b: jnp.sum(jfa.fused_attention_cls(a, b, HEADS, True) * g),
        argnums=(0, 1))(jnp.asarray(q0), jnp.asarray(kv))
    tq = torch.from_numpy(q0).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    (tfa.fused_attention_cls(tq, tkv, HEADS) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_q),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(want_kv),
                               rtol=1e-5, atol=1e-6)


def test_cpu_routes_to_plain_without_launch():
    before = dict(tfa.LAUNCHES)
    x = torch.from_numpy(_qkv(2, 5))
    torch.testing.assert_close(tfa.fused_attention(x, HEADS),
                               tfa.attention_plain(x, HEADS), rtol=0, atol=0)
    q0, kv = x[:, :1, :D].contiguous(), x[:, :, D:].contiguous()
    torch.testing.assert_close(tfa.fused_attention_cls(q0, kv, HEADS),
                               tfa.attention_cls_plain(q0, kv, HEADS),
                               rtol=0, atol=0)
    assert tfa.LAUNCHES == before


def test_launch_checks_reject_non_cuda_inputs():
    x = torch.zeros(2, 5, 3 * D)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._launch_attention(x, HEADS)
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        tfa.fused_attention(x.to("meta"), HEADS)
