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

`k2_plan` and `k1_plan` are the pure functions from which K2's and K1's
CUDA launchers take their geometry (and K1 its design). The plan tests
run them at every shape that chip_smoke.py's phase 3 checks on the card
(`K2_CHECKS`, `K1_CHECKS`) and show that a block fits Hopper's shared
memory, that the blocks cover every (image, head) item exactly once,
that K1 takes the design phase 3 asserts, and that the element path is
taken exactly where 16-byte loads cannot describe the tensor. The pure
parts of phase 3's and phase 4's bounds against the float64 attention
(`float64_check`, `flip_bound`, `bf16_ulp`) are pinned here too.
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", [50, 10])
def test_k2_matches_pallas_at_the_rn50_pool_shape(N, dtype):
    """The RN50 attention pool (`nn/clip_resnet.py`): 32 heads of 64, kv
    width 4096, N = 50 tokens at 224 px and 10 at 96 px, in fp32 (the
    ssl presets' default) and bf16 (`trainer.precision=bf16`)."""
    B, heads, d = 2, 32, 64
    D = heads * d
    g = np.random.default_rng(5)
    q0 = g.normal(size=(B, 1, D)).astype(np.float32)
    kv = g.normal(size=(B, N, 2 * D)).astype(np.float32)
    got = tfa.fused_attention_cls(torch.from_numpy(q0).to(dtype),
                                  torch.from_numpy(kv).to(dtype), heads)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax_k2(jnp.asarray(q0, jdt), jnp.asarray(kv, jdt), heads)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


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


@pytest.mark.parametrize("B,N,heads,d,dt,tol,opt",
                         _cases(chip_smoke.K1_CHECKS, "k1"))
def test_k1_plan_at_the_card_check_shapes(B, N, heads, d, dt, tol, opt):
    """`k1_plan` at every shape phase 3 checks on the card picks the design
    phase 3 asserts, fits Hopper's shared memory and covers every (image,
    head) item exactly once; the tile's persistent blocks take them in
    image-major order, round by round (block i's k-th item is item
    k * blocks + i)."""
    dtype = getattr(torch, dt)
    aligned = not opt.get("unaligned", False)
    plan = tfa.k1_plan(B, N, heads, d, dtype, aligned)
    assert plan.design == chip_smoke.k1_design(N, d, dt, aligned)
    assert 0 < plan.smem <= tfa.MAX_SMEM and plan.items == B * heads
    lists = [plan.block_items(i) for i in range(plan.blocks)]
    assert all(lists)
    assert sorted(sum(lists, [])) == [(b, h) for b in range(B)
                                      for h in range(heads)]
    if plan.design == "wgmma":
        rounds = [lst[k] for k in range(plan.per_block) for lst in lists
                  if k < len(lst)]
        assert rounds == [(b, h) for b in range(B) for h in range(heads)]
        assert plan.blocks == min(tfa.K5_SMS, B * heads)
        assert plan.stages == tfa.TILE_STAGES
        assert plan.smem == tfa.tile_smem(d)
    else:   # runs of consecutive items, image-major
        assert sum(lists, []) == [(b, h) for b in range(B)
                                  for h in range(heads)]


def test_k1_plan_at_the_slice_shapes():
    """B=512 and 256, N=50, 12 heads of 64, bf16: the tile on 132
    persistent blocks, a ring of 4 stages of 24 KB (Q, K and V, a 64 x 64
    box each) beside two 8 KB output tiles: 115,792 bytes."""
    for B, per in ((512, 47), (256, 24)):
        plan = tfa.k1_plan(B, 50, 12, 64, torch.bfloat16)
        assert (plan.design, plan.items, plan.blocks, plan.per_block,
                plan.stages, plan.warps, plan.smem) == (
            "wgmma", B * 12, 132, per, 4, 12, 115792)
    # d = 128: two boxes an operand, still 4 stages (230,480 bytes)
    plan = tfa.k1_plan(3, 50, 2, 128, torch.bfloat16)
    assert (plan.stages, plan.smem) == (4, 230480)
    # outside the tile's scope
    assert tfa.k1_plan(3, 50, 12, 64, torch.bfloat16, False).design == \
        "onepass"
    assert tfa.k1_plan(3, 50, 2, 56, torch.bfloat16).design == "onepass"
    assert tfa.k1_plan(3, 65, 12, 64, torch.bfloat16).design == "rows"
    assert tfa.k1_plan(512, 50, 12, 64, torch.float32).design == "rows"


def test_k1_plan_refuses_shapes_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tfa.k1_plan(1, 8000, 12, 64, torch.bfloat16)


@pytest.mark.parametrize("reading,want", [
    (0.017853, 1.25 * 0.017853),   # phase 4d's plain vs float64 on an H100
    (0.017723, 1.25 * 0.017723),   # plain vs reversed sums
    (0.018280, 1.25 * 0.018280),   # the one-pass tile vs plain
    (0.02, 0.025),                 # the cap, reached exactly
    (0.03, 0.025),                 # a library that moved the plain path
    (0.0, 0.0)])
def test_flip_bound_at_the_recorded_readings_and_cap(reading, want):
    assert chip_smoke.flip_bound(reading) == pytest.approx(want, rel=1e-12)
    assert chip_smoke.flip_bound(reading) <= 0.025


def _bf16_qkv(B=2, N=50, heads=4, d=64, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * heads * d, generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("fn", ["attention_float64", "attention_reversed"])
def test_summation_order_variants_within_one_bf16_ulp_of_plain(fn):
    """Phase 4d's and phase 3's references differ from `attention_plain`
    by at most one bf16 ulp of the plain value at every output: only the
    order (and, for float64, the precision) of their sums differs."""
    qkv = _bf16_qkv()
    want = tfa.attention_plain(qkv, 4)
    got = getattr(chip_smoke, fn)(qkv, 4)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= chip_smoke.bf16_ulp(want.double())).all())


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, -2.0, 0.75, 3e-3, 0.0], dtype=torch.float64)
    want = [2.0**-7, 2.0**-7, 2.0**-6, 2.0**-8, 2.0**-16, 2.0**-133]
    assert chip_smoke.bf16_ulp(x).tolist() == want
    # one ulp up from a bf16 value is the next bf16 value
    b = torch.tensor([1.0, 0.1, -37.5], dtype=torch.bfloat16)
    up = (b.double() + chip_smoke.bf16_ulp(b.double())).to(torch.bfloat16)
    assert bool((up.view(torch.int16) - b.view(torch.int16)).abs().eq(1)
                .all())


def test_float64_check_passes_the_plain_path_and_fails_a_wrong_rounding():
    """`float64_check` holds the plain path itself (share equal, no excess)
    and refuses K1 with its probabilities left unrounded (a wrong rounding
    point: far more outputs move) and an output moved by two ulps."""
    qkv = _bf16_qkv()
    plain = tfa.attention_plain(qkv, 4)
    ref = chip_smoke.attention_float64(qkv, 4)
    assert chip_smoke.float64_check(plain, plain, ref)["ok"]
    B, N, threeD = qkv.shape
    q, k, v = (t.reshape(B, N, 4, 64) for t in qkv.float().split(256, -1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 64**-0.5
    unrounded = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v) \
        .reshape(B, N, 256).to(torch.bfloat16)
    check = chip_smoke.float64_check(unrounded, plain, ref)
    assert not check["ok"] and check["share_kernel"] > check["share_bound"]
    moved = plain.clone()
    moved[0, 0, 0] = (plain[0, 0, 0].double()
                      + 2 * chip_smoke.bf16_ulp(ref[0, 0, 0].double())
                      + (plain[0, 0, 0].double() - ref[0, 0, 0].double())
                      .abs()).to(torch.bfloat16)
    assert not chip_smoke.float64_check(moved, plain, ref)["ok"]
