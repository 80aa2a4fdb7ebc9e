"""Port kernels K3 (entropy-bottleneck likelihood) and K4 (fused MLP
half-block) against the JAX Pallas kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_pallas_eb.py and tests/test_flash_attn.py do. The port's
wrappers route CPU tensors to their plain versions (the CUDA kernels'
arithmetic in plain torch), so this holds that arithmetic, and K3's
analytic backward (`likelihood_backward_plain`, tested further in
tests/test_torch_eb_k3.py), to the TPU kernels.

Tolerances, with their reasons:
* K3 values rtol 1e-5 / atol 1e-7 and gradients rtol 1e-4 / atol 1e-6
  (tests/test_pallas_eb.py's: fp32 chain, summation order and the
  transcendental implementations differ); on moved coefficients the
  gradients' atol scales with their largest entry (see the test);
* K4 fp32 1e-5 (tests/test_flash_attn.py's: summation order), bf16
  atol 2e-2 (one bf16 rounding of the hidden and the output can flip);
* the tiny tower with the MLP on K4, fp32 rtol/atol 1e-4 (the
  test_flash_attn.py check: twelve LayerNorms and matmuls in another
  summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.coding import entropy_bottleneck as jeb
from lossyless_tpu.coding import pallas_eb
from lossyless_tpu.nn import flash_attn as jfa
from lossyless_tpu_torch.coding import eb_kernel
from lossyless_tpu_torch.nn import flash_attn as tfa
from tests import torch_threads  # noqa: F401  (one pool a worker)

K3_VALUES = dict(rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _eb_params(C, filters, seed, scale=0.3):
    """JAX init with every coefficient moved off its init value by
    N(0, scale) (factors are zero at init, which would leave the tanh
    stage's forward untested)."""
    p = jeb.init_params(jeb.EBConfig(C, filters), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) if k == "quantiles" else np.asarray(v)
                + rng.normal(0, scale, v.shape).astype(np.float32))
            for k, v in p.items()}


def _torch(p, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad)
            for k, v in p.items()}


K3_SHAPES = [(37, 13, (3, 3, 3)), (128, 16, (3, 3, 3, 3)), (5, 8, (3, 3, 3)),
             (1, 1, (3, 3, 3, 3)), (9, 130, (2, 4))]


@pytest.mark.parametrize("B,C,filters", K3_SHAPES)
def test_k3_plain_matches_pallas(B, C, filters):
    p = _eb_params(C, filters, seed=B + C)
    z = (np.random.default_rng(B).normal(size=(B, C)) * 4).astype(np.float32)
    want = np.asarray(pallas_eb.likelihood(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(z)))
    got = eb_kernel.likelihood(_torch(p), torch.from_numpy(z)).numpy()
    assert got.shape == (B, C) and got.min() >= 1e-9
    np.testing.assert_allclose(got, want, **K3_VALUES)


@pytest.mark.parametrize("perturb", [0.0, 0.3])
@pytest.mark.parametrize("B,C,filters", K3_SHAPES[:3])
def test_k3_grads_match_pallas(B, C, filters, perturb):
    """perturb=0: the JAX init (zero factors) with z*5, the inputs of
    tests/test_pallas_eb.py, at its tolerance. perturb=0.3 moves every
    coefficient: the sums over the batch then cancel, and both fp32 chains
    land up to ~5e-6 of the gradient's largest entry away from a float64
    evaluation (measured on these inputs, the JAX one as far as the
    port), so atol scales with that entry there."""
    p = _eb_params(C, filters, seed=B + C, scale=perturb)
    z = (np.random.default_rng(B).normal(size=(B, C)) * (4 if perturb else 5)
         ).astype(np.float32)

    def loss(params, zz):
        return -jnp.log(pallas_eb.likelihood(params, zz)).sum()

    jg_p, jg_z = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(z))
    tp = _torch(p, requires_grad=True)
    tz = torch.tensor(z, requires_grad=True)
    (-torch.log(eb_kernel.likelihood(tp, tz)).sum()).backward()
    pairs = {"z": (tz.grad, jg_z)}
    pairs.update({k: (tp[k].grad, jg_p[k]) for k in p if k != "quantiles"})
    assert tp["quantiles"].grad is None  # quantiles do not enter the chain
    for k, (got, want) in pairs.items():
        want = np.asarray(want)
        atol = 1e-6 if not perturb else 2e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_k3_floor_keeps_the_recover_gradient():
    """Far in the tail the likelihood floors at 1e-9; lower_bound lets a
    gradient through that pushes it back up (pallas_eb.py's backward)."""
    p = _eb_params(4, (3, 3, 3), seed=0)
    z = np.full((2, 4), 500.0, np.float32)
    jg = jax.grad(lambda zz: -jnp.log(pallas_eb.likelihood(
        {k: jnp.asarray(v) for k, v in p.items()}, zz)).sum())(
        jnp.asarray(z))
    tz = torch.tensor(z, requires_grad=True)
    lik = eb_kernel.likelihood(_torch(p), tz)
    assert torch.all(lik == 1e-9)
    (-torch.log(lik).sum()).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


def test_k3_packing_matches_the_tpu_kernels_weights():
    """The kernels read the parameters where they lie, through a table of
    pointers (`param_slots`: slot 3 l + 0/1/2 = matrix/bias/factor of
    layer l) in the order of JAX's `pack_weights`: the slots' tensors,
    flattened per channel and concatenated, are JAX's packed weights."""
    p = _eb_params(6, (3, 3, 3, 3), seed=3)
    packed, dims = pallas_eb.pack_weights(
        {k: jnp.asarray(v) for k, v in p.items()})
    slots = eb_kernel.param_slots(_torch(p))
    assert len(slots) == len(packed)
    for slot, name in slots:
        assert name == f"{('matrix', 'bias', 'factor')[slot % 3]}{slot // 3}"
    assert [s for s, _ in slots] == sorted(s for s, _ in slots)
    got = np.concatenate([p[name].reshape(6, -1) for _, name in slots],
                         axis=1)
    want = np.concatenate([np.asarray(w) for w in packed], axis=1)
    np.testing.assert_array_equal(got, want)
    assert eb_kernel.widths(_torch(p)) == (1,) + tuple(d for d, _ in dims)
    assert eb_kernel.n_coeffs(eb_kernel.widths(_torch(p))) == want.shape[1]


def test_k3_refuses_a_device_it_has_no_kernel_for():
    p = {k: v.to("meta") for k, v in _torch(_eb_params(4, (3,), 0)).items()}
    with pytest.raises(ValueError, match="CUDA"):
        eb_kernel.likelihood(p, torch.zeros(3, 4, device="meta"))
    with pytest.raises(ValueError, match="on the CPU or all on a CUDA"):
        eb_kernel.likelihood(p, torch.zeros(3, 4))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _mlp_args(B, N, D, seed=1):
    """The inputs of test_flash_attn.py::test_fused_mlp_block_matches_reference
    (its keys and scales), at shape (B, N, D)."""
    ks = jax.random.split(jax.random.key(seed), 7)
    return [np.asarray(a) for a in (
        jax.random.normal(ks[0], (B, N, D), jnp.float32),
        jax.random.normal(ks[1], (D,)) * 0.1 + 1,
        jax.random.normal(ks[2], (D,)) * 0.1,
        jax.random.normal(ks[3], (D, 4 * D)) * 0.05,
        jax.random.normal(ks[4], (4 * D,)) * 0.05,
        jax.random.normal(ks[5], (4 * D, D)) * 0.05,
        jax.random.normal(ks[6], (D,)) * 0.05)]


def _jax_mlp(args, dtype=jnp.float32):
    x, *w = args
    return jfa.fused_mlp_block(jnp.asarray(x, dtype),
                               *(jnp.asarray(a) for a in w), 1e-5, 8, True)


@pytest.mark.parametrize("B,N", [(4, 10), (3, 7), (1, 5), (7, 2)])
def test_k4_plain_matches_pallas_fp32(B, N):
    args = _mlp_args(B, N, 64)
    want = np.asarray(_jax_mlp(args))
    got = tfa.fused_mlp_block(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k4_grads_match_pallas_fp32():
    args = _mlp_args(4, 10, 64)
    jg = jax.grad(lambda *a: jfa.fused_mlp_block(*a, 1e-5, 8, True).sum(),
                  argnums=tuple(range(7)))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tfa.fused_mlp_block(*ts).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("B,N", [(4, 10), (3, 7)])
def test_k4_plain_matches_pallas_bf16(B, N):
    args = _mlp_args(B, N, 64, seed=2)
    want = np.asarray(_jax_mlp(args, jnp.bfloat16).astype(jnp.float32))
    x, *w = map(torch.from_numpy, args)
    got = tfa.fused_mlp_block(x.to(torch.bfloat16), *w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_k4_wrapper_refuses_what_the_kernel_does_not_take():
    args = [torch.from_numpy(a) for a in _mlp_args(2, 3, 64)]
    with pytest.raises(TypeError, match="bfloat16"):
        tfa._launch_mlp_block(*args, 1e-5)
    odd = [torch.zeros(2, 3, 60, dtype=torch.bfloat16), torch.ones(60),
           torch.zeros(60), torch.zeros(60, 240), torch.zeros(240),
           torch.zeros(240, 60), torch.zeros(60)]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa._launch_mlp_block(*odd, 1e-5)
    with pytest.raises(ValueError, match="on the CPU or all on a CUDA"):
        tfa.fused_mlp_block(args[0].to("meta"), *args[1:])


def test_tiny_tower_mlp_kernel_matches_jax_pallas():
    """The test_flash_attn.py check: the same params through the JAX tower
    with mlp_impl="pallas" and the port's with mlp_impl="kernel"."""
    from lossyless_tpu.nn.vit import VisionTransformer as JViT
    from lossyless_tpu_torch.nn.vit import VisionTransformer as TViT
    from lossyless_tpu_torch.nn.vit import params_from_flax

    kw = dict(patch_size=32, width=64, layers=2, heads=2, out_dim=16)
    jt = JViT(mlp_impl="pallas", dtype=jnp.float32, attn_impl="einsum", **kw)
    x = np.asarray(jax.random.normal(jax.random.key(0), (2, 224, 224, 3)))
    params = jt.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(x)))
    tt = TViT(mlp_impl="kernel", dtype=torch.float32, attn_impl="plain", **kw)
    tt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    before = dict(tfa.LAUNCHES)
    with torch.no_grad():
        got = tt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert tfa.LAUNCHES == before  # CPU tensors launch nothing
    # the same tree either way, and the cls-only last block keeps the ops
    assert set(tt.state_dict()) == set(TViT(**kw).state_dict())
    assert [b.mlp_impl for b in tt.blocks] == ["kernel", "kernel"]
