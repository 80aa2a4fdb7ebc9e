"""Port CLIP tower and preprocess against the JAX package.

The same seeded params (flax init, handed over with `params_from_flax`) and
the same numpy inputs go through both towers. The JAX tower runs its Pallas
attention in interpret mode (`attn_impl="pallas"`), the port its kernels'
plain versions (CPU tensors).

Tolerances: fp32 towers rtol/atol 2e-4 (tests/test_clip_torch_parity.py's:
summation order and LayerNorm variance formula differ); bf16 atol 5e-2
(flax and torch round bf16 at the same places, but one flipped rounding of
a residual-stream value propagates through the blocks); preprocess atol
1e-4 (the same resampling matrices, matmul summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import vit as jvit
from lossyless_tpu_torch.nn import vit as tvit
from tests.test_clip_torch_parity import (IMG, TorchClipVisual,
                                          _state_dict_openai_names)
from tests import torch_threads  # noqa: F401  (one pool a worker)

WIDTH, LAYERS, HEADS, OUT = 64, 3, 4, 512


@pytest.fixture(scope="module")
def params():
    """Seeded flax init of the tiny tower (the tree does not depend on the
    dtype, the attention impl or cls_only_last)."""
    jt = jvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=HEADS, out_dim=OUT, dtype=jnp.float32,
                                attn_impl="einsum")
    p = jt.init(jax.random.key(0),
                jnp.zeros((1, 224, 224, 3), jnp.float32))["params"]
    return jax.tree.map(np.asarray, p)


def _towers(params, dtype, cls_only_last):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt = jvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=HEADS, out_dim=OUT, dtype=jdtype,
                                attn_impl="pallas",
                                cls_only_last=cls_only_last)
    tt = tvit.VisionTransformer(patch_size=32, width=WIDTH, layers=LAYERS,
                                heads=HEADS, out_dim=OUT, dtype=dtype,
                                cls_only_last=cls_only_last)
    tt.load_state_dict(tvit.params_from_flax(params))
    return jt, tt


def test_params_from_flax_names_and_layout(params):
    _, tt = _towers(params, torch.float32, True)
    sd = tvit.params_from_flax(params)
    assert set(sd) == set(tt.state_dict())
    np.testing.assert_array_equal(sd["blocks.2.attn.qkv.kernel"].numpy(),
                                  params["block2"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["patch_embed.kernel"].numpy(),
                                  params["patch_embed"]["kernel"])
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("cls_only_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tower_matches_jax(params, dtype, cls_only_last):
    jt, tt = _towers(params, dtype, cls_only_last)
    x = np.random.default_rng(1).normal(size=(3, 224, 224, 3)).astype(
        np.float32)
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tt(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, OUT) and got.dtype == np.float32
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 \
        else dict(atol=5e-2)
    np.testing.assert_allclose(got, want, **tol)


def test_cls_only_last_is_the_full_towers_class_row(params):
    _, full = _towers(params, torch.float32, False)
    _, cls = _towers(params, torch.float32, True)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(cls(x), full(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(96, 96), (256, 256), (60, 50)])
def test_clip_preprocess_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jvit.clip_preprocess(jnp.asarray(x)))
    got = tvit.clip_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pil_clip_preprocess_is_byte_equal():
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((50, 60), (224, 224), (300, 250))]
    want = jvit.pil_clip_preprocess(images)
    got = tvit.pil_clip_preprocess(images)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("prefix", ["", "visual."])
def test_convert_openai_clip_weights_matches_jax(prefix):
    torch.manual_seed(0)
    ref = TorchClipVisual().eval()
    sd = {prefix + k: v for k, v in _state_dict_openai_names(ref).items()}
    got = tvit.convert_openai_clip_weights(sd)
    want = tvit.params_from_flax(jvit.convert_openai_clip_weights(sd))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_converted_tower_matches_torch_clip():
    """The port's tower on converted weights reproduces the torch CLIP
    layout of tests/test_clip_torch_parity.py (fp32, its tolerance)."""
    from tests.test_clip_torch_parity import HEADS as H, LAYERS as L
    from tests.test_clip_torch_parity import OUT as O, PATCH, W

    torch.manual_seed(1)
    ref = TorchClipVisual().eval()
    x = torch.randn(4, 3, IMG, IMG)
    tt = tvit.VisionTransformer(patch_size=PATCH, width=W, layers=L,
                                heads=H, out_dim=O, image_size=IMG,
                                dtype=torch.float32)
    tt.load_state_dict(tvit.convert_openai_clip_weights(
        _state_dict_openai_names(ref)))
    with torch.no_grad():
        want = ref(x)
        got = tt(x.permute(0, 2, 3, 1))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_init_weights_is_seeded():
    def make(seed):
        t = tvit.VisionTransformer(patch_size=32, width=WIDTH, layers=2,
                                   heads=HEADS, out_dim=OUT,
                                   dtype=torch.float32)
        return t.init_weights(torch.Generator().manual_seed(seed))

    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj"], c["proj"])
    k = a["blocks.0.mlp_fc.kernel"]
    std = (1 / WIDTH) ** 0.5
    assert abs(float(k.std()) - std) < 0.1 * std
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(a["ln_pre.scale"], torch.ones(WIDTH))
