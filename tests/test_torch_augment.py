"""The affine augmentations and the image datasets' batches on the port
against the JAX package (the STL10 half: tests/test_torch_stl10_augment.py).

`jax.random` and torch draw different numbers, so each augmentation is
split into a draw and an apply: the tests draw with JAX's keys, exactly as
JAX's `_rand_affine` does, hand the angles, shifts, scales and shears to
the port's `Affine.apply`, and hold the warped images to JAX's at atol
1e-5 (bilinear sampling of [0, 1] images; grid_sample and map_coordinates
round their coordinates differently). The image `device_sampler` gets
JAX's indices and draws the same way. The port's own draws are checked
for their ranges. `_load_mnist` reads a small idx file the test writes.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.data import augmentations as jaug
from lossyless_tpu.data import images as jimages
from lossyless_tpu_torch.data import augmentations as taug
from lossyless_tpu_torch.data import images as timages
from tests import torch_threads  # noqa: F401  (one pool a worker)

AFFINE = sorted(jaug._AFFINE_PARAMS)
MNIST_EQ = jimages.SPECS["mnist"].default_equivalence


def _batch(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _jax_draws(key, shape, degrees=0.0, translate=(0.0, 0.0),
               scale=(1.0, 1.0), shear=0.0) -> dict:
    """What `jaug._rand_affine(key, batch, ...)` draws, as the port's
    `Affine.draw` names them."""
    b, h, w, _ = shape
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = jax.random.uniform
    d = {"angle": jnp.deg2rad(u(k1, (b,), minval=-degrees, maxval=degrees)),
         "tx": u(k2, (b,), minval=-translate[0], maxval=translate[0]) * w,
         "ty": u(k3, (b,), minval=-translate[1], maxval=translate[1]) * h,
         "scale": u(k4, (b,), minval=scale[0], maxval=scale[1]),
         "shear": jnp.deg2rad(u(k5, (b,), minval=-shear, maxval=shear))}
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in d.items()}


def _augmenter_draws(key, shape, equivalence) -> list:
    """JAX `make_augmenter(equivalence)(key, batch)`'s draws, as the
    port's chain takes them (a list, one draw a member): the merged
    affine is its only function, keyed by the first of one split."""
    (k,) = jax.random.split(key, 1)
    return [_jax_draws(k, shape, **_merged_kwargs(equivalence))]


def _merged_kwargs(equivalence) -> dict:
    return jaug._merged_affine(list(equivalence)).keywords


@pytest.mark.parametrize("name", AFFINE)
def test_each_affine_augmentation_matches_jax(name):
    shape = (6, 12, 10, 2)
    x = _batch(shape, 1)
    key = jax.random.key(3)
    kw = dict(jaug._AFFINE_PARAMS[name])
    want = np.asarray(jaug._rand_affine(key, jnp.asarray(x), **kw))
    got = taug.Affine.apply(torch.from_numpy(x), _jax_draws(key, shape, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the port's affine of the same name has JAX's ranges
    (aff,) = taug.make_augmenter([name]).members
    merged = _merged_kwargs([name])
    assert (aff.degrees, tuple(aff.translate), tuple(aff.scale), aff.shear) \
        == (merged["degrees"], tuple(merged["translate"]),
            tuple(merged["scale"]), merged["shear"])


@pytest.mark.parametrize("equivalence", [
    MNIST_EQ, ("rotation--", "scale--"), ("scale", "scale--"),
    ("x_translation", "y_translation--", "shear")])
def test_make_augmenter_matches_jax(equivalence):
    """The merged warp (the largest range of each kind, the last scale)
    through `make_augmenter`, on JAX's draws."""
    shape = (5, 32, 32, 1)
    x = _batch(shape, 2)
    key = jax.random.key(11)
    want = np.asarray(jaug.make_augmenter(equivalence)(key, jnp.asarray(x)))
    aug = taug.make_augmenter(equivalence)
    got = aug.apply(torch.from_numpy(x),
                    _augmenter_draws(key, shape, equivalence))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert taug.build_augmenter(equivalence) == aug
    assert taug.build_augmenter(()) is None


def test_the_ports_draws_keep_jaxs_ranges():
    aug = taug.make_augmenter(MNIST_EQ)
    n, h, w = 20000, 32, 28
    (d,) = aug.draw(torch.Generator().manual_seed(0), (n, h, w, 1))
    bounds = {"angle": np.deg2rad(45.0), "tx": 0.25 * w, "ty": 0.25 * h,
              "shear": np.deg2rad(25.0)}
    for k, lim in bounds.items():
        v = d[k].numpy()
        assert v.shape == (n,) and -lim <= v.min() < v.max() <= lim, k
        assert abs(v.mean()) < 0.03 * lim and v.max() > 0.99 * lim, k
    s = d["scale"].numpy()
    assert 0.6 <= s.min() < s.max() <= 1.4 and abs(s.mean() - 1.0) < 0.01
    # an identity draw leaves the images as they are
    x = torch.from_numpy(_batch((3, h, w, 2), 4))
    ident = {k: torch.zeros(3) for k in bounds} | {"scale": torch.ones(3)}
    np.testing.assert_allclose(aug.apply(x, [ident]).numpy(), x.numpy(),
                               atol=1e-5)


def test_available_augmentations_and_what_is_not_ported():
    """Every name JAX takes is ported: a non-affine one chains after the
    merged affine (the STL10 half; tests/test_torch_stl10_augment.py holds
    each to JAX); an unknown name raises."""
    assert taug.available_augmentations() == jaug.available_augmentations()
    for name in ("hflip", "vflip", "D4_group", "color", "gray",
                 "resize_crop", "erasing"):
        aug = taug.make_augmenter([name, "rotation"])
        assert aug.members == (taug._merged_affine(["rotation"]),
                               taug._REGISTRY[name])
    with pytest.raises(KeyError):
        taug.make_augmenter(["no_such"])


# ---------------------------------------------------------------------------
# The image dataset: batches and the device sampler
# ---------------------------------------------------------------------------

TARGETS = ["representative", "input", "equiv_x", "target"]


@pytest.mark.parametrize("at", TARGETS)
@pytest.mark.parametrize("normalize", [False, True])
def test_device_sampler_on_jaxs_draws(at, normalize):
    """JAX's `device_sampler(B)(key)` and the port's `build` on the same
    indices and draws: x augmented and normalized, the aux target by
    `additional_target` (equiv_x: a second view, normalized)."""
    kw = dict(name="mnist", synthetic=True, synthetic_n=300,
              additional_target=at, is_normalize=normalize)
    jds, tds = jimages.ImageDataset(**kw), timages.ImageDataset(**kw)
    assert jds.data.tobytes() == tds.data.tobytes()
    B, key = 16, jax.random.key(5)
    want = jds.device_sampler(B)(key)
    k_idx, k_aug, k_aux, _ = jax.random.split(key, 4)
    idx = torch.from_numpy(np.asarray(
        jax.random.randint(k_idx, (B,), 0, len(jds)), np.int64))
    shape = (B, *tds.spec.shape)
    sampler = tds.device_sampler(B)
    got = sampler.build(idx, _augmenter_draws(k_aug, shape, MNIST_EQ),
                        _augmenter_draws(k_aux, shape, MNIST_EQ))
    for name, w, g in zip(("x", "y", "aux"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5 * (1 + 3 * normalize),
                                   err_msg=name)
    # its own draws: shapes, dtypes, and aux by the contract
    x, y, aux = sampler(torch.Generator().manual_seed(0))
    assert x.shape == shape and x.dtype == torch.float32 and y.shape == (B,)
    assert 0 <= int(y.min()) and int(y.max()) < 10


def test_batches_augment_with_the_epochs_generator():
    """`batches(seed)` warps x by draws from a generator seeded with
    `seed` (x first, then an equiv_x view); the representative is the raw
    image; is_augment=False gives the raw images."""
    kw = dict(name="mnist", synthetic=True, synthetic_n=120)
    ds = timages.ImageDataset(**kw)
    x, y, aux = next(ds.batches(8, seed=4))
    order = np.random.default_rng(4).permutation(len(ds))[:8]
    raw = torch.from_numpy(ds.data[order]).float() / 255.0
    np.testing.assert_array_equal(aux.numpy(), raw.numpy())
    np.testing.assert_array_equal(y.numpy(), ds.targets[order])
    aug = taug.make_augmenter(MNIST_EQ)
    g = torch.Generator().manual_seed(4)
    np.testing.assert_allclose(
        x.numpy(), aug.apply(raw, aug.draw(g, raw.shape)).numpy(),
        atol=1e-6)
    assert not np.allclose(x.numpy(), raw.numpy())
    eq = timages.ImageDataset(**kw, additional_target="equiv_x")
    x2, _, pos = next(eq.batches(8, seed=4))
    np.testing.assert_array_equal(x2.numpy(), x.numpy())
    np.testing.assert_allclose(
        pos.numpy(), aug.apply(raw, aug.draw(g, raw.shape)).numpy(),
        atol=1e-6)
    plain = timages.ImageDataset(**kw, is_augment=False)
    np.testing.assert_array_equal(next(plain.batches(8, seed=4))[0].numpy(),
                                  raw.numpy())


def test_label_equivalence_waits_for_the_stl10_half():
    """The STL10 half is ported: MNIST's batches with a
    `label_equivalence` are warped, then cropped jointly with their
    labels (`build` on the epoch generator's draws); an unknown key of
    the equivalence's kwargs raises; without augmentation the batch is
    raw."""
    ds = timages.ImageDataset(
        name="mnist", synthetic=True, synthetic_n=40,
        label_equivalence={"invariant_scale": (0.5, 1.0), "p": 1.0})
    x, y, aux = next(ds.batches(4, seed=2))
    assert x.shape == (4, 32, 32, 1)
    order = np.random.default_rng(2).permutation(len(ds))[:4]
    raw = torch.from_numpy(ds.data[order]).float() / 255.0
    g = torch.Generator().manual_seed(2)
    want = ds.build(raw, torch.from_numpy(ds.targets[order]),
                    *ds.draws(g, raw.shape))
    assert torch.equal(want[0], x) and torch.equal(want[1], y)
    assert torch.equal(aux, raw)
    bad = timages.ImageDataset(name="mnist", synthetic=True, synthetic_n=40,
                               label_equivalence={"scale": (0.5, 1.0)})
    with pytest.raises(TypeError):
        next(bad.batches(4))
    ds.is_augment = False
    assert torch.equal(next(ds.batches(4, seed=2))[0], raw)


# ---------------------------------------------------------------------------
# MNIST's idx files
# ---------------------------------------------------------------------------


def _write_idx(root, name, n, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    with gzip.open(raw / f"{name}-images-idx3-ubyte.gz", "wb") as f:
        f.write(np.array([2051, n, 28, 28], ">i4").tobytes() + imgs.tobytes())
    with gzip.open(raw / f"{name}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(np.array([2049, n], ">i4").tobytes() + labels.tobytes())
    return labels


def test_load_mnist_reads_idx_files_as_jax_does(tmp_path):
    labels = _write_idx(tmp_path, "t10k", 7, seed=1)
    _write_idx(tmp_path, "train", 30, seed=2)
    want = jimages._load_mnist(tmp_path, "test")
    got = timages._load_mnist(tmp_path, "test")
    assert got[0].shape == (7, 32, 32, 1) and got[0].dtype == np.uint8
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(got[1], labels.astype(np.int64))
    ds = timages.ImageDataset(name="mnist", split="test", data_dir=tmp_path)
    assert len(ds) == 7 and ds.data.tobytes() == want[0].tobytes()
    carved = timages.ImageDataset(name="mnist", split="train",
                                  data_dir=tmp_path)
    assert len(carved) == 27   # 10% of the 30 carved off for validation


def test_missing_mnist_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        timages.ImageDataset(name="mnist", split="test", data_dir=tmp_path)
