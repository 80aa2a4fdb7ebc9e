"""Port attention variants K5a (packed) and K5b (head-batched) against JAX.

JAX's `fused_attention` picks `_attn_kernel_packed` when `IMAGE_PACK > 1`
and `_attn_kernel_headbatched` when `HEAD_BATCH` is set; it runs them here
in interpret mode, as tests/test_flash_attn.py does. The port's
`fused_attention` reads its own knobs of the same names and, on CPU
tensors, takes the matching plain version (`attention_packed_plain`,
`attention_headbatched_plain`), which repeats the CUDA kernels' arithmetic.

`k5_plan`, the pure function the CUDA launchers take their design and
geometry from, is run at every shape chip_smoke.py's phase 3c checks on
the card (`K5_CHECKS`).

Tolerances are tests/test_flash_attn.py's: fp32 rtol/atol 1e-5 (summation
order; the packed product also sums the masked zeros), bf16 atol 2e-2 (one
bf16 rounding of the probabilities and the output); gradients rtol 1e-5 /
atol 1e-6 (both backwards recompute through the plain formulation in fp32);
the tiny tower at tests/test_torch_vit.py's fp32 tolerance, 2e-4.
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import flash_attn as jfa
from lossyless_tpu.nn import vit as jvit
from lossyless_tpu_torch.nn import flash_attn as tfa
from lossyless_tpu_torch.nn import vit as tvit

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from tests import torch_threads  # noqa: F401  (one pool a worker)

D, HEADS = 96, 4
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(atol=2e-2)


@contextlib.contextmanager
def knobs(**kw):
    """Set IMAGE_PACK / HEAD_BATCH / BLOCK_LIMIT on both packages."""
    saved = [(m, k, getattr(m, k)) for m in (jfa, tfa) for k in kw]
    try:
        for m in (jfa, tfa):
            for k, v in kw.items():
                setattr(m, k, v)
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def _qkv(B, N, seed=0, width=D):
    return np.random.default_rng(seed).normal(size=(B, N, 3 * width)).astype(
        np.float32)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _both(x, dtype, heads=HEADS):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jfa.fused_attention(jnp.asarray(x, jdt), heads, True)
    got = tfa.fused_attention(torch.from_numpy(x).to(dtype), heads)
    assert got.dtype == dtype
    return _np(got), _np(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [2, 4, 8, 64, 3])
def test_packed_matches_jax(pack, dtype):
    """Packs 2, 4, 8; 64 clamps to the image block; 3 at B=8 steps down
    to 2 (tests/test_flash_attn.py's cases)."""
    x = _qkv(8, 50, seed=pack)
    with knobs(IMAGE_PACK=pack):
        assert tfa.attention_variant(torch.zeros(8, 50, 3 * D))[0] == "packed"
        got, want = _both(x, dtype)
    np.testing.assert_allclose(got, want,
                               **(FP32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_headbatched_matches_jax(dtype):
    x = _qkv(8, 50, seed=5)
    with knobs(HEAD_BATCH=True):
        assert tfa.attention_variant(torch.zeros(8, 50, 3 * D)) == \
            ("headbatched", 1)
        got, want = _both(x, dtype)
    np.testing.assert_allclose(got, want,
                               **(FP32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("B,N,heads,width", [(7, 37, 3, 120), (6, 5, 2, 66),
                                             (4, 10, 4, 32)])
def test_variants_at_odd_shapes(B, N, heads, width):
    """Odd batch and token counts and head dims (40, 33, 8) in fp32: each
    variant's plain version equals JAX's kernel and K1's plain version."""
    x = _qkv(B, N, seed=B + N, width=width)
    k1 = _np(tfa.attention_plain(torch.from_numpy(x), heads))
    for kw in (dict(IMAGE_PACK=B), dict(IMAGE_PACK=2), dict(HEAD_BATCH=True),
               dict(IMAGE_PACK=3, HEAD_BATCH=True)):
        with knobs(**kw):
            got, want = _both(x, torch.float32, heads)
        np.testing.assert_allclose(got, want, **FP32, err_msg=str(kw))
        np.testing.assert_allclose(got, k1, **FP32, err_msg=str(kw))


def _jax_pack(B, N, threeD, itemsize):
    """JAX's rule as `fused_attention` applies it (flash_attn.py:223-227),
    on its own block functions and knobs."""
    G = jfa._block_size(B, jfa._vmem_block_limit(N * threeD * itemsize))
    pack = min(jfa.IMAGE_PACK, G)
    while G % pack:
        pack -= 1
    return pack


@pytest.mark.parametrize("block_limit", [16, 8, 5])
def test_effective_pack_follows_jax(block_limit):
    for B in (1, 7, 8, 12, 128, 256, 512):
        for pack in (1, 2, 3, 4, 8, 16, 64):
            for N, threeD, item in ((50, 2304, 2), (50, 2304, 4),
                                    (50, 288, 4), (197, 2304, 2)):
                with knobs(IMAGE_PACK=pack, BLOCK_LIMIT=block_limit):
                    assert tfa.effective_pack(B, N, threeD, item) == \
                        _jax_pack(B, N, threeD, item), (B, pack, N, item)
    # the slice shape: every pack up to 16 is taken as asked in bf16; fp32
    # halves the image block, so 16 steps down to 8
    with knobs(IMAGE_PACK=16):
        assert tfa.effective_pack(512, 50, 2304, 2) == 16
        assert tfa.effective_pack(512, 50, 2304, 4) == 8
    with knobs(IMAGE_PACK=3):
        assert tfa.effective_pack(8, 50, 288, 4) == 2


def test_pack_wins_over_head_batch():
    q = torch.zeros(8, 50, 3 * D)
    with knobs(IMAGE_PACK=4, HEAD_BATCH=True):
        assert tfa.attention_variant(q) == ("packed", 4)
    with knobs(IMAGE_PACK=1, HEAD_BATCH=True):
        assert tfa.attention_variant(q) == ("headbatched", 1)
    assert tfa.attention_variant(q) == ("k1", 1)


@pytest.mark.parametrize("kw", [dict(IMAGE_PACK=4), dict(HEAD_BATCH=True)],
                         ids=["packed", "headbatched"])
def test_gradient_matches_jax(kw):
    x = _qkv(4, 10, seed=21, width=32)
    g = np.random.default_rng(22).normal(size=(4, 10, 32)).astype(np.float32)
    with knobs(**kw):
        want = jax.grad(lambda t: jnp.sum(jfa.fused_attention(t, 4, True)
                                          * g))(jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        (tfa.fused_attention(t, 4) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_plain_versions_route_without_launch():
    x = torch.from_numpy(_qkv(4, 6))
    before = dict(tfa.LAUNCHES)
    with knobs(IMAGE_PACK=2):
        torch.testing.assert_close(tfa.fused_attention(x, HEADS),
                                   tfa.attention_packed_plain(x, HEADS, 2),
                                   rtol=0, atol=0)
    with knobs(HEAD_BATCH=True):
        torch.testing.assert_close(tfa.fused_attention(x, HEADS),
                                   tfa.attention_headbatched_plain(x, HEADS),
                                   rtol=0, atol=0)
    assert tfa.LAUNCHES == before
    assert {"fused_attention_packed", "fused_attention_headbatched"} <= \
        set(tfa.LAUNCHES)


def test_launches_reject_bad_inputs():
    x = torch.zeros(4, 5, 3 * D)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._launch_attention_packed(x, HEADS, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._launch_attention_headbatched(x, HEADS)
    with pytest.raises(ValueError, match="does not divide"):
        tfa.attention_packed_plain(x, HEADS, 3)
    with knobs(IMAGE_PACK=2):
        with pytest.raises(ValueError, match="CPU or all on a CUDA"):
            tfa.fused_attention(x.to("meta"), HEADS)


WIDTH, LAYERS, THEADS = 64, 2, 2


@pytest.fixture(scope="module")
def tower_params():
    jt = jvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=THEADS, out_dim=16, dtype=jnp.float32,
                                image_size=64, attn_impl="einsum")
    p = jt.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return jax.tree.map(np.asarray, p["params"])


@pytest.mark.parametrize("kw", [dict(IMAGE_PACK=4), dict(HEAD_BATCH=True)],
                         ids=["packed", "headbatched"])
def test_tiny_tower_under_each_knob(tower_params, kw):
    """A 2-block fp32 tower at 64 px (N=5) on 8 images: the knob reaches
    block 0's attention in both packages (block 1 is class-token only)."""
    jt = jvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=THEADS, out_dim=16, dtype=jnp.float32,
                                image_size=64, attn_impl="pallas")
    tt = tvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=THEADS, out_dim=16, dtype=torch.float32,
                                image_size=64)
    tt.load_state_dict(tvit.params_from_flax(tower_params))
    x = np.random.default_rng(3).normal(size=(8, 64, 64, 3)).astype(
        np.float32)
    base = np.asarray(jt.apply({"params": tower_params}, jnp.asarray(x)))
    with knobs(**kw):
        want = np.asarray(jt.apply({"params": tower_params}, jnp.asarray(x)))
        calls = []
        real = tfa.attention_variant
        tfa.attention_variant = lambda q: calls.append(real(q)) or real(q)
        try:
            with torch.no_grad():
                got = tt(torch.from_numpy(x)).numpy()
        finally:
            tfa.attention_variant = real
    assert calls and calls[0][0] == ("packed" if "IMAGE_PACK" in kw
                                     else "headbatched")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, base, rtol=2e-4, atol=2e-4)


def _k5_cases():
    def name(c):
        return "-".join(map(str, (*c[:5], *c[5].items(), *c[6])))
    return [pytest.param(*c, id=name(c)) for c in chip_smoke.K5_CHECKS]


@pytest.mark.parametrize("B,N,heads,d,dt,kw,opt", _k5_cases())
def test_k5_plan_at_the_card_check_shapes(B, N, heads, d, dt, kw, opt):
    """`k5_plan` at every shape phase 3c checks on the card: a block fits
    Hopper's shared memory, the blocks cover every (image, head) item
    exactly once, bf16 at N <= 64 takes K1's tiles (the TMA/wgmma tile
    where d is a multiple of 16 and the pointers are aligned, else the
    one-pass tile), the two-pass tile above, fp32 the row code."""
    dtype = getattr(torch, dt)
    with knobs(**kw):
        variant, pack = tfa.attention_variant(
            torch.zeros(B, N, 3 * heads * d, dtype=dtype))
    assert variant == ("packed" if "IMAGE_PACK" in kw else "headbatched")
    aligned = not opt.get("unaligned", False)
    plan = tfa.k5_plan(B, N, heads, d, dtype, pack, aligned)
    assert 0 < plan.smem <= tfa.MAX_SMEM
    assert plan.design == chip_smoke.k5_design(N, d, dt, aligned)
    assert plan.design == ("fma" if dtype == torch.float32 else
                           "twopass" if N > 64 else
                           "wgmma" if d % 16 == 0 and aligned
                           else "onepass")
    covered = [it for i in range(plan.blocks) for it in plan.block_items(i)]
    assert sorted(covered) == [(b, h) for b in range(B)
                               for h in range(heads)]
    assert all(plan.block_items(i) for i in range(plan.blocks))
    if plan.design == "wgmma":
        assert plan.warps == 12 and plan.stages == tfa.TILE_STAGES
        assert plan.vec and plan.blocks == min(tfa.K5_SMS, B * heads)
        assert plan.smem == tfa.tile_smem(d)
    else:
        assert plan.vec == (aligned and (d * dtype.itemsize) % 16 == 0)
    if plan.design == "onepass":
        assert plan.warps == -(-N // 16) and plan.stages >= 2
    elif plan.design in ("twopass", "fma") and variant == "packed":
        for i in range(plan.blocks):   # one head of one group's images
            items = plan.block_items(i)
            assert len({h for _, h in items}) == 1
            assert len({b // pack for b, _ in items}) == 1
    elif plan.design in ("twopass", "fma"):
        # the heads a pass stages, which the launch hands the kernel
        assert 1 <= plan.heads_per_pass <= heads
        assert (plan.heads_per_pass, plan.smem) == tfa.k5b_pass(
            N, heads, d, dtype)


def test_k5_plan_at_the_slice_shape():
    """B=512, N=50, 12 heads of 64, bf16, every pack and head-batched:
    K1's TMA/wgmma tile, 6144 items on 132 persistent blocks (47 at most a
    block), 4 ring stages of Q, K and V (a 64 x 64 box each); at B=300 the
    blocks take 27 or 28 items. K5a and K5b list the items as K1 does."""
    k1 = tfa.k1_plan(512, 50, 12, 64, torch.bfloat16)
    for pack in (1, 2, 4, 8, 16):
        plan = tfa.k5_plan(512, 50, 12, 64, torch.bfloat16, pack)
        assert (plan.design, plan.items, plan.per_block, plan.blocks,
                plan.stages) == ("wgmma", 6144, 47, 132, 4)
        assert plan.smem == 1024 + 4 * 3 * 8192 + 2 * 8192 + 10 * 8
        assert [plan.block_items(i) for i in range(plan.blocks)] == \
            [k1.block_items(i) for i in range(k1.blocks)]
    plan = tfa.k5_plan(300, 50, 12, 64, torch.bfloat16, 1)
    assert sorted({len(plan.block_items(i)) for i in range(plan.blocks)}) \
        == [27, 28]
    assert tfa.k5_plan(2, 65, 12, 64, torch.bfloat16, 1).design == "twopass"
    with pytest.raises(ValueError, match="divide"):
        tfa.k5_plan(6, 50, 12, 64, torch.bfloat16, 4)


@pytest.mark.parametrize("B,N,heads,d,dt,kw,opt", [
    c for c in _k5_cases() if c.values[4] == "bfloat16" and c.values[1] <= 64])
def test_variants_plans_give_one_item_list(B, N, heads, d, dt, kw, opt):
    """At bf16 N <= 64, K1, K5a (at the pack the knob gives) and K5b run
    one kernel on one plan: the same design, geometry and item list (the
    tiles ignore the pack, so the plans are equal), image-major (item i: image i // heads, head i % heads)."""
    dtype = getattr(torch, dt)
    with knobs(**kw):
        _, pack = tfa.attention_variant(
            torch.zeros(B, N, 3 * heads * d, dtype=dtype))
    aligned = not opt.get("unaligned", False)
    k1 = tfa.k1_plan(B, N, heads, d, dtype, aligned)
    lists = [[k1.block_items(i) for i in range(k1.blocks)]]
    for p in sorted({1, pack}):
        plan = tfa.k5_plan(B, N, heads, d, dtype, p, aligned)
        assert plan == k1   # no field of the plan differs, `pack` included
        lists.append([plan.block_items(i) for i in range(plan.blocks)])
    assert all(lst == lists[0] for lst in lists)
    assert [tfa.attention_item(i, heads) for i in range(2 * heads)] == \
        [(b, h) for b in range(2) for h in range(heads)]


@pytest.mark.parametrize("B,N,heads,d,dt,kw,opt", _k5_cases())
def test_k5_matches_pallas_at_the_card_check_shapes(B, N, heads, d, dt, kw,
                                                    opt):
    """Every K5a/K5b case phase 3c checks on the card, cut to one image
    group (K5a) or two images (K5b): the plain version the card's checks
    hold the kernels to, against JAX's kernel under the same knob."""
    dtype = getattr(torch, dt)
    with knobs(**kw):
        _, pack = tfa.attention_variant(torch.zeros(B, N, 3 * heads * d,
                                                    dtype=dtype))
        x = _qkv(pack if "IMAGE_PACK" in kw else min(B, 2), N, seed=N + d,
                 width=heads * d)
        got, want = _both(x, dtype, heads)
    np.testing.assert_allclose(got, want,
                               **(FP32 if dtype == torch.float32 else BF16))
