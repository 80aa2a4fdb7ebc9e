"""CLIP's text tower (`nn/clip_text.py`) against flax's.

A tiny `TextTransformer` (vocab 100, context 16, width 32, 2 layers, 2
heads) in JAX and the port from the same weights: a seeded OpenAI-layout
state dict (made by chip_smoke.py) through both converters, bit for
bit, or JAX's tree carried by `layers.params_from_flax`. Token rows are
numpy-seeded, each with its <end> token (the row's largest id) at a
different place. Tolerances: fp32 rtol 1e-5 (atol 1e-5 of the largest
entry), bf16 atol 2e-2 of it (tests/test_flash_attn.py's).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import clip_text as jtext
from lossyless_tpu_torch.nn import clip_text as ttext
from lossyless_tpu_torch.nn import layers as tlayers

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TINY = dict(vocab_size=100, context_length=16, width=32, layers=2, heads=2,
            out_dim=24)


def _state_dict(seed=0):
    return chip_smoke.openai_clip_text_state_dict(
        vocab=100, context=16, width=32, layers=2, out_dim=24, seed=seed,
        dtype=torch.float16)


def _tokens(n, seed=1, length=16):
    """Rows of ids in [1, 98] with the <end> token 99 at a random place,
    zero padding after it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 99, (n, length))
    for i, end in enumerate(rng.integers(1, length, n)):
        ids[i, end] = 99
        ids[i, end + 1:] = 0
    return ids.astype(np.int32)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2 * scale)


def test_converter_matches_jax():
    sd = _state_dict()
    want = tlayers.params_from_flax(jtext.convert_openai_clip_text_weights(sd))
    got = ttext.convert_openai_clip_text_weights(sd)
    assert set(got) == set(want) == set(ttext.TextTransformer(
        **TINY).state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("length", [16, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_matches_flax(dtype, length):
    """The converted weights in both towers: the embeddings, pooled at each
    row's largest id; rows shorter than the context too."""
    sd = _state_dict()
    ids = _tokens(6, length=length)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jtext.TextTransformer(dtype=jd, **TINY)
    want = jax.jit(jm.apply)(
        {"params": jtext.convert_openai_clip_text_weights(sd)},
        jnp.asarray(ids))
    tm = ttext.TextTransformer(dtype=dtype, **TINY)
    tm.load_state_dict(ttext.convert_openai_clip_text_weights(sd))
    got = tm(torch.from_numpy(ids).long()).detach()
    assert got.dtype == torch.float32
    _close(got, want, dtype)


def test_flax_init_tree_carries_over():
    """JAX's own initialized tree loads into the port's tower as it is."""
    jm = jtext.TextTransformer(dtype=jnp.float32, **TINY)
    ids = _tokens(3, seed=2)
    v = jm.init(jax.random.key(0), jnp.asarray(ids))
    tm = ttext.TextTransformer(dtype="float32", **TINY)
    tm.load_state_dict(tlayers.params_from_flax(jax.tree.map(np.asarray,
                                                             v["params"])))
    _close(tm(torch.from_numpy(ids).long()).detach(),
           jm.apply(v, jnp.asarray(ids)), "float32")


def test_featurize_captions_batches_and_empty_input(monkeypatch):
    """fp32 on the CPU, with the tower cut to the tiny sizes: a ragged
    last batch gives the rows one batch gives, an empty input (0, 512).
    The device is the card unless the call names one."""
    monkeypatch.setattr(ttext, "TextTransformer", functools.partial(
        ttext.TextTransformer, **TINY))
    sd = ttext.convert_openai_clip_text_weights(_state_dict(seed=5))
    ids = _tokens(5, seed=3)
    want = ttext.featurize_captions(sd, ids, batch_size=5, device="cpu",
                                    dtype="float32")
    got = ttext.featurize_captions(sd, ids, batch_size=2, device="cpu",
                                   dtype="float32")
    assert got.shape == (5, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ttext.featurize_captions(sd, ids[:0], device="cpu").shape == \
        (0, 512)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttext.featurize_captions(sd, ids)
