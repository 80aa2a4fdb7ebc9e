"""The attention and tower knobs against the JAX package: `SOFTMAX_DTYPE`
in K1 and K2, the tower's `ln_dtype` and `remat`, and the registry that
passes the tower's two through `encoder.arch_kwargs`.

JAX runs its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attn.py does; the port's wrappers send CPU tensors to
their plain versions, which repeat the CUDA kernels' bf16 chain.
Tolerances: the bf16 softmax at test_flash_attn.py's bf16 atol 2e-2, on
its unit-normal inputs. The plain chain rounds at every point of the TPU
kernel's; XLA on the CPU does not all of them (its excess precision drops
the bf16 rounding of p / sum before an fp32 io cast: JAX's probabilities
there are fp32 quotients of the rounded exps by the rounded sum), which
moves an output by up to a few bf16 ulps of p times |v|. `remat` at JAX's
own test_vit.py tolerances (atol 1e-6 on the output, rtol 1e-5 / atol 1e-6
on the gradients); the fp32 tower with a bf16 `ln_dtype` at
test_torch_vit.py's fp32 tolerance 2e-4 (both round the same fp32
LayerNorm outputs to bf16; an output within roundoff of a rounding
boundary may round the other way).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import flash_attn as jfa
from lossyless_tpu.nn import vit as jvit
from lossyless_tpu_torch.nn import flash_attn as tfa
from lossyless_tpu_torch.nn import vit as tvit
from lossyless_tpu_torch.nn.registry import get_architecture
from tests import torch_threads  # noqa: F401  (one pool a worker)

BF16_ATOL = 2e-2
WIDTH, LAYERS, HEADS, OUT = 64, 2, 2, 32

# (B, N, heads, d): the slice's shape cut to a few images, the one-pass
# tile's (d = 40) and the row code's (N = 65) scopes, the RN50 pool's heads
SOFTMAX_SHAPES = [(3, 50, 12, 64), (2, 17, 2, 40), (2, 65, 1, 32),
                  (2, 10, 32, 64)]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_k1(qkv, heads, sm):
    jfa.SOFTMAX_DTYPE = sm      # read while tracing; `sm` keys the cache
    try:
        return jfa.fused_attention(qkv, heads, True)
    finally:
        jfa.SOFTMAX_DTYPE = jnp.float32


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_k2(q0, kv, heads, sm):
    jfa.SOFTMAX_DTYPE = sm
    try:
        return jfa.fused_attention_cls(q0, kv, heads, True)
    finally:
        jfa.SOFTMAX_DTYPE = jnp.float32


@pytest.fixture
def bf16_softmax(monkeypatch):
    monkeypatch.setattr(tfa, "SOFTMAX_DTYPE", torch.bfloat16)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,heads,d", SOFTMAX_SHAPES)
def test_bf16_softmax_plain_matches_jax(B, N, heads, d, io, monkeypatch):
    """K1 and K2 with SOFTMAX_DTYPE=bfloat16, port plain vs JAX's Pallas
    kernels; the knob moves the result (it is not the fp32 chain)."""
    D = heads * d
    x = np.random.default_rng(B * N + d).normal(
        size=(B, N, 3 * D)).astype(np.float32)
    jdt = jnp.float32 if io == torch.float32 else jnp.bfloat16
    t, j = torch.from_numpy(x).to(io), jnp.asarray(x, jdt)
    q0, kv = t[:, :1, :D].contiguous(), t[:, :, D:].contiguous()
    fp32 = (tfa.fused_attention(t, heads), tfa.fused_attention_cls(
        q0, kv, heads))
    monkeypatch.setattr(tfa, "SOFTMAX_DTYPE", torch.bfloat16)
    got1 = tfa.fused_attention(t, heads)
    got2 = tfa.fused_attention_cls(q0, kv, heads)
    assert got1.dtype == got2.dtype == io
    np.testing.assert_allclose(_np(got1), _np(_jax_k1(j, heads,
                                                      jnp.bfloat16)),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(
        _np(got2), _np(_jax_k2(j[:, :1, :D], j[:, :, D:], heads,
                               jnp.bfloat16)), atol=BF16_ATOL)
    for a, b in zip(fp32, (got1, got2)):
        assert not torch.equal(a, b)


def test_bf16_softmax_rounding_points(bf16_softmax):
    """The plain chain rounds exactly where the TPU kernel does: every
    probability is a bf16 value, the row sums are 1 to bf16 accuracy, and
    each probability is the bf16 quotient of a rounded exp by the rounded
    fp32 sum of the rounded exps."""
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3, 7, 50)).astype(np.float32) * 30)
    p = tfa._scaled_softmax_to(logits, 0.125, torch.float32)
    assert torch.equal(p, p.to(torch.bfloat16).float())
    l = (logits.to(torch.bfloat16) * 0.125).to(torch.bfloat16).float()
    e = torch.exp((l - l.amax(-1, keepdim=True)).to(torch.bfloat16)
                  .float()).to(torch.bfloat16).float()
    s = e.sum(-1, keepdim=True).to(torch.bfloat16).float()
    torch.testing.assert_close(p, (e / s).to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(p.sum(-1), torch.ones(4, 3, 7), rtol=0,
                               atol=0.05)


@pytest.mark.parametrize("knob", ["IMAGE_PACK", "HEAD_BATCH"])
def test_bf16_softmax_refused_under_pack_and_head_batch(knob, monkeypatch):
    """JAX's refusal, with JAX's message, in the port's wrapper."""
    x = np.random.default_rng(0).normal(size=(4, 5, 3 * 16)).astype(
        np.float32)
    value = 2 if knob == "IMAGE_PACK" else True
    monkeypatch.setattr(tfa, knob, value)
    monkeypatch.setattr(tfa, "SOFTMAX_DTYPE", torch.bfloat16)
    with pytest.raises(NotImplementedError) as got:
        tfa.fused_attention(torch.from_numpy(x), 2)
    monkeypatch.setattr(jfa, knob, value)
    monkeypatch.setattr(jfa, "SOFTMAX_DTYPE", jnp.bfloat16)
    with pytest.raises(NotImplementedError) as want:
        jfa.fused_attention(jnp.asarray(x), 2, True)
    assert str(got.value) == str(want.value)
    # the per-head kernel honours it, and an unknown dtype is refused
    monkeypatch.setattr(tfa, knob, 1 if knob == "IMAGE_PACK" else False)
    tfa.fused_attention(torch.from_numpy(x), 2)
    monkeypatch.setattr(tfa, "SOFTMAX_DTYPE", torch.float16)
    with pytest.raises(ValueError, match="SOFTMAX_DTYPE"):
        tfa.fused_attention(torch.from_numpy(x), 2)


def test_bf16_softmax_backward_is_the_fp32_recompute(bf16_softmax):
    """The backward recomputes through the fp32 plain version whatever the
    knob, as JAX's backward goes through `_reference_attention`."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 9, 3 * 32)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 9, 32)).astype(np.float32))
    (got,) = torch.autograd.grad(tfa.fused_attention(x, 4), x, g)
    (want,) = torch.autograd.grad(
        tfa.attention_plain(x, 4, torch.float32), x, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# ln_dtype and remat
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jt = jvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=HEADS, out_dim=OUT, dtype=jnp.float32,
                                attn_impl="einsum")
    p = jt.init(jax.random.key(0),
                jnp.zeros((1, 224, 224, 3), jnp.float32))["params"]
    return jax.tree.map(np.asarray, p)


def _tower(params, **kw):
    t = tvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                               heads=HEADS, out_dim=OUT, **kw)
    t.load_state_dict(tvit.params_from_flax(params))
    return t


def _images(n=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, 224, 224, 3)).astype(np.float32)


def test_ln_dtype_bf16_is_bit_equal_in_a_bf16_tower(params):
    """flax's LayerNorm(dtype=bf16) keeps fp32 statistics and rounds only
    its output, which the bf16 tower rounds anyway: nothing changes."""
    x = torch.from_numpy(_images())
    with torch.no_grad():
        a = _tower(params, dtype=torch.bfloat16)(x)
        b = _tower(params, dtype=torch.bfloat16,
                   ln_dtype=torch.bfloat16)(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ln_dtype_bf16_fp32_tower_matches_jax(params):
    """In an fp32 tower the knob rounds each LayerNorm's output (ln_pre's
    and the blocks', not ln_post's) to bf16: the port against JAX's
    ln_dtype tower, and both away from the fp32 LayerNorms."""
    x = _images()
    jt = jvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=HEADS, out_dim=OUT, dtype=jnp.float32,
                                attn_impl="pallas", ln_dtype=jnp.bfloat16)
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _tower(params, dtype=torch.float32,
                     ln_dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
        fp32 = _tower(params, dtype=torch.float32)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(got - fp32).max() > 1e-4


def test_remat_matches_forward_and_grads(params):
    """remat=True recomputes each block in the backward: the same output
    and gradients (JAX's test_vit.py tolerances), the same state dict."""
    x = torch.from_numpy(_images())
    towers = [_tower(params, dtype=torch.float32, remat=r)
              for r in (False, True)]
    assert list(towers[0].state_dict()) == list(towers[1].state_dict())
    outs, grads = [], []
    for t in towers:
        z = t(x)
        outs.append(z.detach())
        grads.append(torch.autograd.grad((z ** 2).sum(),
                                         list(t.parameters())))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for a, b in zip(grads[0], grads[1]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_remat_recomputes_the_kernels(params, monkeypatch):
    """Under remat a training forward launches K1 twice a block (the
    recompute): the launch count the card's checks expect."""
    calls = []
    plain = tfa.attention_plain

    def counting(qkv, heads, softmax=None):
        if softmax is None:       # the forward's call, not the backward's
            calls.append(1)
        return plain(qkv, heads, softmax)

    monkeypatch.setattr(tfa, "attention_plain", counting)
    x = torch.from_numpy(_images())
    for remat, want in ((False, LAYERS - 1), (True, 2 * (LAYERS - 1))):
        calls.clear()
        t = _tower(params, dtype=torch.float32, remat=remat)
        t(x).sum().backward()
        assert len(calls) == want
        calls.clear()
        with torch.no_grad():      # no recompute without a backward
            t(x)
        assert len(calls) == LAYERS - 1


def test_registry_passes_the_tower_knobs():
    """`encoder.arch_kwargs.ln_dtype=bfloat16` and `...remat=true`, as the
    override strings give them, reach the tower."""
    from lossyless_tpu_torch.pipeline import config

    cfg = config.apply_overrides(config.preset("clip_hub"), [
        "encoder.arch_kwargs.width=64", "encoder.arch_kwargs.layers=2",
        "encoder.arch_kwargs.heads=2", "encoder.arch_kwargs.ln_dtype=bfloat16",
        "encoder.arch_kwargs.remat=true"])
    t = get_architecture(cfg.encoder.arch, (224, 224, 3), 16,
                         generator=torch.Generator().manual_seed(0),
                         **cfg.encoder.arch_kwargs)
    assert t.remat is True
    assert t.ln_pre.dtype == t.blocks[0].ln_1.dtype == torch.bfloat16
    assert t.ln_post.dtype == torch.float32
    t = get_architecture("clip", (224, 224, 3), 16, width=64, layers=2,
                         heads=2, remat="false", ln_dtype=torch.float32)
    assert t.remat is False and t.blocks[1].ln_2.dtype == torch.float32
