"""Offline ingestion (`data/ingest.py`) of the port against the JAX package.

Byte for byte: the TFRecord files each package writes (and reads of the
other's), the tf.Example encoding and its parse, `hash_tokenize`, and the
trees `ingest_tfds`, `ingest_kaggle_galaxy` and `ingest_coco_clip` write
from one generated fixture (file names, JPEG bytes, `.npy` arrays; COCO
with one `text_encode_fn` handed to both). The default caption encoder:
the port's text tower carrying JAX's initialized tree gives JAX's caption
features in fp32 within rtol 1e-5 (atol 1e-5 of the largest entry,
tests/test_torch_clip_text.py's), built once for every call, on the card
unless a device is named.
"""

import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lossyless_tpu.data import ingest as jingest
from lossyless_tpu.nn import clip_text as jtext
from lossyless_tpu_torch.data import ingest as tingest
from lossyless_tpu_torch.nn import clip_text as ttext
from lossyless_tpu_torch.nn import layers as tlayers

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from tests import torch_threads  # noqa: F401  (one pool a worker)

# a text tower at CLIP's vocabulary and context (hash_tokenize's ids),
# narrow and shallow
TOWER = dict(width=32, layers=2, heads=2, out_dim=24)


def _jpeg(rng, size=(40, 50)) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8)).save(
        buf, "JPEG")
    return buf.getvalue()


def _examples(rng):
    return [{"image": _jpeg(rng), "label": [3], "weights": [0.5, -1.25],
             "name": "a b"},
            {"image": _jpeg(rng, (30, 20)), "label": [-2],
             "ids": [1, 2 ** 40, -7]},
            {"image": [b"x", b"yz"], "label": [0], "f": [1e-3]}]


def _tree(root: Path) -> dict:
    """{relative path: bytes} of every file under `root`."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_tf_example_bytes_and_parse_match_jax():
    for ex in _examples(np.random.default_rng(0)):
        payload = tingest.encode_tf_example(ex)
        assert payload == jingest.encode_tf_example(ex)
        assert tingest.parse_tf_example(payload) == \
            jingest.parse_tf_example(payload)


def test_tfrecord_bytes_match_jax_and_read_across(tmp_path):
    payloads = [tingest.encode_tf_example(e)
                for e in _examples(np.random.default_rng(1))] + [b""]
    tingest.write_tfrecord(tmp_path / "t.tfrecord", payloads)
    jingest.write_tfrecord(tmp_path / "j.tfrecord", payloads)
    assert (tmp_path / "t.tfrecord").read_bytes() == \
        (tmp_path / "j.tfrecord").read_bytes()
    assert list(tingest.read_tfrecord(tmp_path / "j.tfrecord")) == payloads
    assert list(jingest.read_tfrecord(tmp_path / "t.tfrecord")) == payloads
    for value in (b"", b"\x00" * 9, bytes(range(256)) * 3):
        assert tingest._masked_crc(value) == jingest._masked_crc(value)
    raw = bytearray((tmp_path / "t.tfrecord").read_bytes())
    raw[20] ^= 0xFF
    (tmp_path / "bad.tfrecord").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        list(tingest.read_tfrecord(tmp_path / "bad.tfrecord"))


def test_hash_tokenize_matches_jax():
    texts = ["A man riding a horse.", "", "two DOGS " * 60, "ünïcode wörds"]
    for kw in ({}, dict(context_length=16, vocab_size=100)):
        np.testing.assert_array_equal(tingest.hash_tokenize(texts, **kw),
                                      jingest.hash_tokenize(texts, **kw))


def test_ingest_tfds_tree_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    shard = tmp_path / "pets-train.tfrecord-00000"
    tingest.write_tfrecord(shard, [tingest.encode_tf_example(
        {"image": _jpeg(rng, (60 + 7 * i, 50)), "label": [i % 3]})
        for i in range(7)])
    for pkg, name in ((tingest, "t"), (jingest, "j")):
        pkg.ingest_tfds([shard], "pets37", tmp_path / name, "train",
                        label_names=["cat", "big dog", "a/b"], min_size=48)
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert t == j and len(t) == 8
    assert "pets37/train/big_dog/1.jpeg" in t


def test_ingest_kaggle_galaxy_tree_matches_jax(tmp_path):
    raw = chip_smoke.write_kaggle_tree(tmp_path / "raw", 6, 3, side=90)
    for pkg, name in ((tingest, "t"), (jingest, "j")):
        pkg.ingest_kaggle_galaxy(raw, tmp_path / name, resolution=32,
                                 crop=64)
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert t == j
    assert {"galaxy/train_targets.npy", "galaxy/train_ids.npy",
            "galaxy/test_ids.npy", "galaxy/test/2th_img.jpeg"} <= set(t)
    targets = np.load(tmp_path / "t" / "galaxy" / "train_targets.npy")
    # the generated targets sum as the published ones: question 1 to 1
    np.testing.assert_allclose(targets[:, :3].sum(1), 1, atol=1e-5)


def _fake_encoder(texts):
    """Deterministic features of a caption list (shape (n, 8))."""
    return np.asarray([[len(t) + k for k in range(8)] for t in texts],
                      np.float32)


def test_ingest_coco_tree_matches_jax(tmp_path):
    raw = chip_smoke.write_coco_tree(tmp_path / "raw", 5, 3,
                                     sizes=((40, 30), (24, 48)))
    for pkg, name in ((tingest, "t"), (jingest, "j")):
        for split in ("train", "test"):
            pkg.ingest_coco_clip(raw, tmp_path / name, split,
                                 text_encode_fn=_fake_encoder, size=32,
                                 limit=4)
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert t == j
    assert "coco_captions/train/3th_features.npy" in t
    assert "coco_captions/train/4th_img.jpeg" not in t     # the limit
    feats = np.load(tmp_path / "t" / "coco_captions" / "test" /
                    "0th_features.npy")
    assert feats.shape == (chip_smoke.COCO_CAPTIONS, 8)


def test_default_text_encoder_gives_jaxs_features_built_once(monkeypatch):
    captions = ["a dog on the grass", "Two people standing near a bus.",
                "", "food " * 90]
    jm = jtext.TextTransformer(dtype=jnp.float32, **TOWER)
    tokens = jnp.asarray(jingest.hash_tokenize(captions))
    v = jm.init(jax.random.key(0), tokens)
    want = np.asarray(jm.apply(v, tokens))
    tm = ttext.TextTransformer(dtype="float32", **TOWER)
    tm.load_state_dict(tlayers.params_from_flax(
        jax.tree.map(np.asarray, v["params"])))
    encode = tingest._default_text_encoder("cpu", model=tm)
    got = encode(captions)
    assert got.dtype == np.float32 and got.shape == (4, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(encode(captions[:2]), got[:2])

    # without a model the tower is built once, from a generator seeded
    # with 0, and serves every call
    built, tower = [], ttext.TextTransformer

    def counting(generator=None):
        built.append(generator)
        return tower(dtype="float32", generator=generator, **TOWER)

    monkeypatch.setattr(ttext, "TextTransformer", counting)
    encode = tingest._default_text_encoder("cpu")
    a, b = encode(captions[:1]), encode(captions[:1])
    assert len(built) == 1 and built[0].initial_seed() == 0
    np.testing.assert_array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tingest._default_text_encoder()
