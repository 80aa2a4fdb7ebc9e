"""K4's plan and its plain version at the ViT-B/32 width, and phase 4d's
two summation-order variants of the plain attention.

`k4_plan` (a pure function in `nn/flash_attn.py`) picks K4's design and
geometry; it is run here at every shape chip_smoke.py's phase 3b checks on
the card (`chip_smoke.K4_CHECKS`) and at the slice shape. The plain K4 is
held to JAX's `fused_mlp_block` (Pallas interpret mode) at D = 768 with a
ragged M, bf16 at atol 2e-2 (tests/test_flash_attn.py's tolerance: one
bf16 rounding of the hidden and of the output can flip).
"""

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
from tests import torch_threads  # noqa: F401  (one pool a worker)

SLICE = (128 * 50, 768, 3072)    # clip_hub's batch of 128 at ViT-B/32


def _cases():
    def name(c):
        B, N, D, opt = c
        return f"B{B}-N{N}-D{D}" + ("-offset" if opt else "")
    return [pytest.param(*c, id=name(c)) for c in chip_smoke.K4_CHECKS]


def _covers(product, M: int, N: int):
    cols, rows = product.grid
    assert product.n_tile % 8 == 0 and product.n_tile <= 256
    assert product.n_tile * cols == N
    assert rows * tfa.K4_TILE_M >= M > (rows - 1) * tfa.K4_TILE_M
    assert 1 <= product.blocks <= min(tfa.K5_SMS, cols * rows)
    assert product.stages >= 2
    assert product.smem == tfa._k4_tile_smem(product.n_tile, product.stages)
    assert product.smem <= tfa.MAX_SMEM


@pytest.mark.parametrize("B,N,D,opt", _cases())
def test_k4_plan_at_the_card_check_shapes(B, N, D, opt):
    M, H = B * N, 4 * D
    plan = tfa.k4_plan(M, D, H)
    assert plan.design == chip_smoke.k4_design(D)
    assert plan.smem <= tfa.MAX_SMEM
    if plan.design == "wgmma":
        _covers(plan.fc, M, H)
        _covers(plan.proj, M, D)
        assert plan.smem == max(plan.fc.smem, plan.proj.smem)
    else:
        assert plan.blocks * tfa.K4_MMA_ROWS >= M
        assert D <= tfa.K4_MMA_MAX_D and H % tfa.K4_MMA_CHUNK == 0


def test_k4_plan_at_the_slice_shape():
    M, D, H = SLICE
    plan = tfa.k4_plan(M, D, H)
    assert plan.design == "wgmma"
    # fc: 24 x 50 = 1200 tiles of 128 x 128; proj: 6 x 50 = 300; each on
    # one persistent block an SM
    assert (plan.fc.n_tile, plan.fc.grid) == (128, (24, 50))
    assert (plan.proj.n_tile, plan.proj.grid) == (128, (6, 50))
    assert plan.fc.blocks == plan.proj.blocks == 132
    assert plan.fc.stages == plan.proj.stages == 4


@pytest.mark.parametrize("M,D,H,match", [
    (6, 60, 240, "multiples of 8"),
    (6, 64, 100, "multiples of 8"),
    (6, 800, 3200, "no K4 design"),
    (6, 768, 3080, "no K4 design"),
    (0, 64, 256, "empty"),
])
def test_k4_plan_refuses_what_no_design_takes(M, D, H, match):
    with pytest.raises(ValueError, match=match):
        tfa.k4_plan(M, D, H)


def test_k4_plan_keeps_the_mma_sync_design_where_wgmma_cannot():
    # width 96 (not a multiple of 64) and hidden a multiple of 32
    assert tfa.k4_plan(3, 96, 384).design == "mma_sync"
    assert tfa.k4_plan(3, 64, 96).design == "mma_sync"   # H not x64
    assert tfa.k4_plan(3, 64, 256).design == "wgmma"


def test_k4_plain_matches_pallas_at_width_768_ragged():
    """B=3, N=50: M = 150 rows, one full and one ragged 128-row tile."""
    B, N, D = 3, 50, 768
    ks = jax.random.split(jax.random.key(6), 7)
    args = [np.asarray(a) for a in (
        jax.random.normal(ks[0], (B, N, D), jnp.float32),
        jax.random.normal(ks[1], (D,)) * 0.1 + 1,
        jax.random.normal(ks[2], (D,)) * 0.1,
        jax.random.normal(ks[3], (D, 4 * D)) * 0.02,
        jax.random.normal(ks[4], (4 * D,)) * 0.02,
        jax.random.normal(ks[5], (4 * D, D)) * 0.02,
        jax.random.normal(ks[6], (D,)) * 0.02)]
    x, *w = args
    want = np.asarray(jfa.fused_mlp_block(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w), 1e-5, 8,
        True).astype(jnp.float32))
    got = tfa.fused_mlp_block(torch.from_numpy(x).to(torch.bfloat16),
                              *map(torch.from_numpy, w))
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_quick_gelu_plain_matches_the_tpu_kernels_formula():
    """`quick_gelu_plain` (which `mlp_block_plain` applies, and which
    chip_smoke.py holds K4's epilogue to at every bf16 value) against
    `_mlp_kernel`'s formula evaluated by JAX on the CPU, at every bf16
    value whose QuickGELU is finite and not tiny."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    h = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    got = tfa.quick_gelu_plain(h).float().numpy()
    hj = jnp.asarray(h.float().numpy(), jnp.bfloat16)
    one = jnp.asarray(1.0, jnp.bfloat16)
    want = np.asarray((hj * (one / (one + jnp.exp(
        jnp.asarray(-1.702, jnp.bfloat16) * hj)))).astype(jnp.float32))
    ok = np.isfinite(want) & (np.abs(want) > 1e-30)
    assert ok.sum() > 40000
    # bf16 values, each op rounded: equal up to one bf16 ulp where the
    # two libraries' fp32 exp round differently
    np.testing.assert_allclose(got[ok], want[ok], rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_summation_order_variants_compute_the_plain_attention(dtype, tol):
    """Phase 4d's variants differ from `attention_plain` only in the order
    (and, for float64, the precision) of their sums."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 7, 3 * 4 * 16, generator=g).to(dtype)
    want = tfa.attention_plain(qkv, 4).float()
    for fn in (chip_smoke.attention_float64, chip_smoke.attention_reversed):
        got = fn(qkv, 4)
        assert got.dtype == dtype and got.shape == (2, 7, 64)
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   rtol=tol, atol=tol)


def test_plain_attention_swap_is_restored():
    from lossyless_tpu_torch.nn import vit

    saved = vit.attention_plain
    with chip_smoke.PlainAttention(chip_smoke.attention_reversed):
        assert vit.attention_plain is chip_smoke.attention_reversed
    assert vit.attention_plain is saved
