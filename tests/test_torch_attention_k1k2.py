"""K1 and K2 at the main path's head shape, at the tile edges of a Hopper
redesign and at every shape the card's checks run, against the JAX
Pallas kernels; and the launch plan K2's wrapper chooses for its kernel.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attn.py does; the port's wrappers send CPU tensors to
their plain versions, which repeat the CUDA kernels' arithmetic (q.k in
fp32 scaled after the dot, fp32 softmax normalized as p / sum before the
cast to the io dtype, fp32 P.V). Tolerances are test_flash_attn.py's:
fp32 rtol/atol 1e-5 (summation order only), bf16 atol 2e-2 (one bf16
rounding of the probabilities and of the output).

`k2_plan` is the pure function from which K2's CUDA launcher takes its
geometry. The plan test runs it at every shape that chip_smoke.py's
phase 3 checks on the card (`K2_CHECKS`) and shows that a block fits
Hopper's shared memory, that the blocks cover every (image, head) item
exactly once, and that the element path is taken exactly where 16-byte
loads cannot describe the tensor.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import flash_attn as jfa
from lossyless_tpu_torch.nn import flash_attn as tfa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(atol=2e-2)
TOL = {torch.float32: FP32, torch.bfloat16: BF16}
DTYPES = [torch.float32, torch.bfloat16]


@functools.partial(jax.jit, static_argnums=1)
def _jax_k1(qkv, heads):
    return jfa.fused_attention(qkv, heads, True)


@functools.partial(jax.jit, static_argnums=2)
def _jax_k2(q0, kv, heads):
    return jfa.fused_attention_cls(q0, kv, heads, True)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _both(x, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return torch.from_numpy(x).to(dtype), jnp.asarray(x, jdt)


def _check_k1_k2(B, N, heads, d, dtype, seed):
    """Port K1 and K2 (plain versions, via the wrappers) against JAX's
    Pallas kernels on the same numpy inputs; K2 is K1's token-0 row."""
    D = heads * d
    x = np.random.default_rng(seed).normal(size=(B, N, 3 * D)).astype(
        np.float32)
    t, j = _both(x, dtype)
    got1 = tfa.fused_attention(t, heads)
    assert got1.dtype == dtype and got1.shape == (B, N, D)
    np.testing.assert_allclose(_np(got1), _np(_jax_k1(j, heads)),
                               **TOL[dtype])
    q0, kv = t[:, :1, :D].contiguous(), t[:, :, D:].contiguous()
    got2 = tfa.fused_attention_cls(q0, kv, heads)
    want2 = _jax_k2(j[:, :1, :D], j[:, :, D:], heads)
    np.testing.assert_allclose(_np(got2), _np(want2), **TOL[dtype])
    np.testing.assert_allclose(_np(got2), _np(got1[:, :1]), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k1_k2_match_pallas_at_the_main_head_shape(dtype):
    """ViT-B/32: N=50 tokens, 12 heads of 64."""
    _check_k1_k2(2, 50, 12, 64, dtype, seed=50)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", [1, 16, 17, 64, 65])
def test_k1_k2_match_pallas_at_the_tile_edges(N, dtype):
    """One token, full and partly filled row-quads and 8-key groups, the
    largest register tile (64) and one token past it (the row code)."""
    _check_k1_k2(2, N, 12, 64, dtype, seed=N)


def test_k2_matches_pallas_at_the_rn50_pool_shape():
    """The RN50 attention pool: fp32, 32 heads of 64, kv width 4096."""
    B, N, heads, d = 2, 50, 32, 64
    D = heads * d
    g = np.random.default_rng(5)
    q0 = g.normal(size=(B, 1, D)).astype(np.float32)
    kv = g.normal(size=(B, N, 2 * D)).astype(np.float32)
    got = tfa.fused_attention_cls(torch.from_numpy(q0),
                                  torch.from_numpy(kv), heads)
    want = _jax_k2(jnp.asarray(q0), jnp.asarray(kv), heads)
    np.testing.assert_allclose(_np(got), _np(want), **FP32)


def _cases(checks, kernel):
    def name(case):
        return "-".join(map(str, (kernel, *case[:5], *case[6].values())))
    return [pytest.param(*c, id=name(c)) for c in checks]


@pytest.mark.parametrize("B,N,heads,d,dt,tol,opt",
                         _cases(chip_smoke.K1_CHECKS, "k1"))
def test_k1_k2_match_pallas_at_the_card_check_shapes(B, N, heads, d, dt, tol,
                                                     opt):
    """Every K1 shape phase 3 checks on the card, at B <= 2 (K2 on its
    token-0 row): the plain versions the card's checks hold the kernels
    to, against JAX's kernels."""
    _check_k1_k2(min(B, 2), N, heads, d, getattr(torch, dt), seed=N + d)


@pytest.mark.parametrize("B,N,heads,d,dt,tol,opt",
                         _cases(chip_smoke.K2_CHECKS, "k2"))
def test_plan_fits_covers_every_item_once_and_picks_the_path(
        B, N, heads, d, dt, tol, opt):
    dtype = getattr(torch, dt)
    aligned = not opt.get("unaligned", False)
    plan = tfa.k2_plan(B, N, heads, d, dtype, aligned)
    assert plan.warps == min(tfa.K2_WARPS, B * heads)
    assert 0 < plan.smem <= tfa.MAX_SMEM
    assert plan.items == B * heads
    # warp w of block i takes item i * warps + w, if there is one
    blocks = [[i * plan.warps + w for w in range(plan.warps)
               if i * plan.warps + w < plan.items]
              for i in range(plan.blocks)]
    assert sorted(sum(blocks, [])) == list(range(B * heads))  # each once
    assert all(blocks)                                        # none idle
    assert plan.vec == (aligned and (d * dtype.itemsize) % 16 == 0)


def test_k2_plan_at_the_main_path_shapes():
    """bf16, N=50, 12 heads of 64: 8 warps a block, each with q0 (64
    floats) and the probabilities (52) in shared memory; 16-byte loads."""
    for B in (512, 256, 7):
        plan = tfa.k2_plan(B, 50, 12, 64, torch.bfloat16)
        assert plan.warps == 8 and plan.vec
        assert plan.smem == 4 * 8 * (64 + 52)
        assert plan.blocks == -(-B * 12 // 8)
    assert tfa.k2_plan(7, 50, 12, 64, torch.bfloat16).items % 8  # ragged
    assert tfa.k2_plan(1, 5, 4, 64, torch.float32).warps == 4


@pytest.mark.parametrize("itemsize", [2, 4])
def test_element_path_exactly_where_16_byte_copies_fail(itemsize):
    for d in range(1, tfa.MAX_D + 1):
        for aligned in (True, False):
            want = aligned and d * itemsize % 16 == 0
            assert tfa.sixteen_byte_path(d, itemsize, aligned) == want


def test_plans_refuse_shapes_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tfa.k2_plan(1, 8000, 12, 64, torch.bfloat16)
