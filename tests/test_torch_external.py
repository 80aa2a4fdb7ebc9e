"""The external datasets (`data/external.py`) and the file loaders of
`data/images.py` against the JAX package.

Byte for byte: `GalaxyZooDataset`'s synthetic images and targets per split
and seed; the unaugmented batches of `GalaxyZooDataset` (every
`additional_target`, shuffled or not, the ragged tail; synthetic and from
an ingested tree), `CocoClipDataset` (the images and the picked caption
features, which share one numpy generator with the permutation) and
`StreamingImageFolder`; the CIFAR-10 / CIFAR-100 pickle loaders and
`load_image_folder` on generated fixtures. Galaxy's augmented chain
(`resize_crop`, `D4_group`, `color`, `gray`) on JAX's draws within 8e-5
of JAX's batches: the STL10 chain's bound (ROADMAP queue 3 item 11).
`get_datamodule` routes the external names and refuses an unknown one.
"""

import dataclasses
import pickle
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from lossyless_tpu.data import external as jext
from lossyless_tpu.data import images as jimages
from lossyless_tpu.data import ingest as jingest
from lossyless_tpu_torch.data import external as text
from lossyless_tpu_torch.data import images as timages
from tests.test_torch_stl10_augment import CHAIN_ATOL, jax_chain_draws

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from tests import torch_threads  # noqa: F401  (one pool a worker)

TARGETS = ["target", "input", "representative", "equiv_x", None]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_batches(jbatches, tbatches):
    jb, tb = list(jbatches), list(tbatches)
    assert len(tb) == len(jb) > 0
    for j, t in zip(jb, tb):
        for a, b in zip(j, t):
            assert b.device.type == "cpu"
            np.testing.assert_array_equal(_np(b), _np(a))
    return tb


@pytest.fixture(scope="module")
def galaxy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("galaxy")
    raw = chip_smoke.write_kaggle_tree(root / "raw", 7, 5, side=80)
    jingest.ingest_kaggle_galaxy(raw, root / "data", resolution=24, crop=64)
    return root / "data"


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_galaxy_matches_jax(split):
    for seed in (0, 3):
        kw = dict(split=split, synthetic=True, synthetic_n=6, seed=seed,
                  resolution=16)
        j, t = jext.GalaxyZooDataset(**kw), text.GalaxyZooDataset(**kw)
        np.testing.assert_array_equal(t._synth_x, j._synth_x)
        np.testing.assert_array_equal(t.targets, j.targets)
        assert len(t) == len(j) == 6
        assert dataclasses.astuple(t.spec) == dataclasses.astuple(j.spec)


@pytest.mark.parametrize("target", TARGETS)
def test_galaxy_batches_match_jax(target, galaxy_root):
    """Unaugmented: synthetic and ingested, shuffled over two epochs and
    in order with the ragged tail."""
    for kw in (dict(synthetic=True, synthetic_n=11, resolution=16),
               dict(data_dir=galaxy_root, resolution=24)):
        kw.update(additional_target=target, is_augment=False)
        j, t = jext.GalaxyZooDataset(**kw), \
            text.GalaxyZooDataset(device="cpu", **kw)
        assert t.aux_shape == j.aux_shape
        _same_batches(j.batches(4, n_epochs=2, seed=5),
                      t.batches(4, n_epochs=2, seed=5))
        _same_batches(j.batches(4, seed=0, shuffle=False, drop_last=False),
                      t.batches(4, seed=0, shuffle=False, drop_last=False))


def test_galaxy_test_split_ids_and_missing_tree(galaxy_root, tmp_path):
    j = jext.GalaxyZooDataset(split="test", data_dir=galaxy_root)
    t = text.GalaxyZooDataset(split="test", data_dir=galaxy_root)
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_array_equal(t.targets, j.targets)
    assert len(t) == 5
    with pytest.raises(FileNotFoundError, match="ingest_kaggle_galaxy"):
        text.GalaxyZooDataset(data_dir=tmp_path)
    if not torch.cuda.is_available():   # the batches' device: the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(t.batches(2))


@pytest.mark.parametrize("target", ["input", "equiv_x"])
def test_galaxy_augmented_chain_on_jax_draws(target, monkeypatch):
    """The port's batches with JAX's draws (x's chain, then the positive's,
    from `split(key)` as JAX's loop takes them) within 8e-5 of JAX's."""
    kw = dict(synthetic=True, synthetic_n=9, resolution=24,
              additional_target=target)
    j = jext.GalaxyZooDataset(**kw)
    t = text.GalaxyZooDataset(device="cpu", **kw)
    eq = j.equivalence
    assert tuple(t.equivalence) == tuple(eq) == \
        ("resize_crop", "D4_group", "color", "gray")
    shape = (4, 24, 24, 3)
    key, draws = jax.random.key(2), []
    for _ in range(2):          # two full batches of an epoch
        for _ in range(2 if target == "equiv_x" else 1):
            key, k = jax.random.split(key)
            draws.append(jax_chain_draws(eq, k, shape))
    it = iter(draws)
    monkeypatch.setattr(text, "_view", lambda augment, g, raw:
                        augment.apply(raw, next(it)))
    jb, tb = list(j.batches(4, seed=2)), list(t.batches(4, seed=2))
    assert len(jb) == len(tb) == 2
    for (jx, jy, ja), (tx, ty, ta) in zip(jb, tb):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                   atol=CHAIN_ATOL)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                   atol=CHAIN_ATOL)
    assert not torch.equal(tb[0][0], tb[0][2]) or target == "input"


def test_coco_batches_match_jax(tmp_path):
    raw = chip_smoke.write_coco_tree(tmp_path / "raw", 9, 2,
                                     sizes=((40, 30), (24, 48)))

    def encode(texts):   # a distinct feature row a caption
        return np.asarray([[zlib.crc32(s.encode()) % 97 + k
                            for k in range(6)] for s in texts], np.float32)

    for split in ("train", "test"):
        jingest.ingest_coco_clip(raw, tmp_path / "data", split,
                                 text_encode_fn=encode, size=48)
    j = jext.CocoClipDataset(data_dir=tmp_path / "data")
    t = text.CocoClipDataset(data_dir=tmp_path / "data", device="cpu")
    assert len(t) == 9 and t.aux_shape == j.aux_shape == (6,)
    tb = _same_batches(j.batches(4, n_epochs=2, seed=7),
                       t.batches(4, n_epochs=2, seed=7))
    assert tb[0][0].shape == (4, 224, 224, 3)
    assert (tb[0][1] == -1).all()
    _same_batches(j.batches(4, seed=1, shuffle=False, drop_last=False),
                  t.batches(4, seed=1, shuffle=False, drop_last=False))
    # validation reads train; test its own split
    assert text.CocoClipDataset(split="validation",
                                data_dir=tmp_path / "data").split == "train"
    assert len(text.CocoClipDataset(split="test",
                                    data_dir=tmp_path / "data")) == 2
    with pytest.raises(FileNotFoundError, match="ingest_coco_clip"):
        text.CocoClipDataset(data_dir=tmp_path / "nowhere")


def _image_folder(root: Path, classes=("n01", "n02", "n03"), per=3,
                  seed=0):
    rng = np.random.default_rng(seed)
    for c in classes:
        (root / c).mkdir(parents=True)
        for i in range(per):
            h, w = rng.integers(20, 40, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                root / c / f"{i}.{'png' if i % 2 else 'jpeg'}")
    (root / "n01" / "notes.txt").write_text("skipped")


@pytest.mark.parametrize("target", ["target", "representative", "equiv_x"])
def test_streaming_image_folder_matches_jax(target, tmp_path):
    _image_folder(tmp_path / "imagenet256" / "train")
    _image_folder(tmp_path / "imagenet256" / "val", per=2, seed=1)
    kw = dict(data_dir=tmp_path, additional_target=target, is_augment=False)
    j, t = jext.StreamingImageFolder(**kw), \
        text.StreamingImageFolder(device="cpu", **kw)
    assert t.classes == j.classes and len(t) == 9
    assert t.aux_shape == j.aux_shape and t.n_classes == 1000
    _same_batches(j.batches(4, n_epochs=2, seed=3),
                  t.batches(4, n_epochs=2, seed=3))
    v = text.StreamingImageFolder(split="test", device="cpu", **kw)
    jv = jext.StreamingImageFolder(split="test", **kw)
    _same_batches(jv.batches(4, seed=0, drop_last=False),
                  v.batches(4, seed=0, drop_last=False))


def test_get_datamodule_routes_the_external_names(tmp_path):
    _image_folder(tmp_path / "imagenet" / "train")
    ds = timages.get_datamodule("imagenet", data_dir=tmp_path)
    assert isinstance(ds, text.StreamingImageFolder) and len(ds) == 9
    with pytest.raises(FileNotFoundError, match="imagenet"):
        timages.get_datamodule("imagenet", data_dir=tmp_path / "none")
    for name in ("coco_clip", "coco_captions"):
        with pytest.raises(FileNotFoundError, match="coco_captions"):
            timages.get_datamodule(name, data_dir=tmp_path)
    assert isinstance(timages.get_datamodule(
        "galaxy_zoo", synthetic=True, synthetic_n=2, resolution=8),
        text.GalaxyZooDataset)
    for name in ("cifar1000", "coco"):
        with pytest.raises(ValueError, match="unknown dataset"):
            timages.get_datamodule(name)
        with pytest.raises(ValueError, match="unknown dataset"):
            jimages.get_datamodule(name)
    assert set(text.EXTERNAL_DATASETS) == {"imagenet", "coco_clip",
                                           "coco_captions", "galaxy_zoo"}


def _cifar_files(root: Path, seed=0):
    rng = np.random.default_rng(seed)
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, f)
    base = root / "cifar-100-python"
    base.mkdir()
    for name in ("train", "test"):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), np.uint8),
                         b"fine_labels": rng.integers(0, 100, 4).tolist(),
                         b"coarse_labels": [0] * 4}, f)


def test_cifar_loaders_match_jax(tmp_path):
    _cifar_files(tmp_path)
    for split in ("train", "test"):
        for n100 in (False, True):
            tx, ty = timages._load_cifar(tmp_path, split, n100=n100)
            jx, jy = jimages._load_cifar(tmp_path, split, n100=n100)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    assert timages._load_cifar(tmp_path, "train")[0].shape == (15, 32, 32, 3)
    for name in ("cifar10", "cifar100"):
        kw = dict(name=name, split="test", data_dir=tmp_path)
        t, j = timages.ImageDataset(**kw), jimages.ImageDataset(**kw)
        assert not j.synthetic
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.targets, j.targets)


def test_load_image_folder_and_folder_datasets_match_jax(tmp_path):
    _image_folder(tmp_path / "pets37" / "test")
    tx, ty, tc = timages.load_image_folder(tmp_path / "pets37" / "test",
                                           (20, 24))
    jx, jy, jc = jimages.load_image_folder(tmp_path / "pets37" / "test",
                                           (20, 24))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tc == jc and tx.shape == (9, 20, 24, 3)
    kw = dict(name="pets37", split="test", data_dir=tmp_path)
    t, j = timages.ImageDataset(**kw), jimages.ImageDataset(**kw)
    assert not j.synthetic and t.data.shape == (9, 96, 96, 3)
    np.testing.assert_array_equal(t.data, j.data)
    with pytest.raises(FileNotFoundError):
        timages.ImageDataset(name="food101", split="test", data_dir=tmp_path)
    (tmp_path / "empty" / "a").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no images"):
        timages.load_image_folder(tmp_path / "empty", (8, 8))
