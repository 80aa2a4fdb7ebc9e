"""The STL10 augmentations, `label_augment` and the image datasets'
batches under them, on the port against the JAX package.

`jax.random` and torch draw different numbers, so each augmentation is a
draw and an apply: the tests draw with JAX's keys exactly as JAX's
functions do, hand the draws to the port's `apply`, and hold the images
to JAX's. Tolerances, with their reasons:

* flips, D4, grayscale and erasing: atol 1e-6 (selections and one
  weighted sum of three channels);
* colour jitter: atol 1e-5 (means over the image and the channels, summed
  in another order);
* `resize_crop`: atol 2e-5. JAX resamples through weight matrices
  (`scale_and_translate`), the port through `grid_sample`'s bilinear
  taps; on 96 x 96 x 3 uniform images the two differ by up to ~1.6e-5,
  and by ~3e-6 on the identity crop;
* `EquivariantRandomResizedCrop`: the crop's 2e-5;
* a chain and the datasets' batches: the crop's 2e-5 carried through the
  colour jitter that follows it, whose brightness, contrast, saturation
  and hue steps each scale a difference by at most 1.4 (1.4^4 < 4):
  8e-5, times 4 where the batch is normalized (STL10's standard
  deviations are ~0.26).

The port's own draws are checked for JAX's ranges and probabilities,
each probability within 5 standard errors over 20,000 samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.data import augmentations as jaug
from lossyless_tpu.data import images as jimages
from lossyless_tpu.data import label_augment as jlabel
from lossyless_tpu_torch.data import augmentations as taug
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.data import label_augment as tlabel
from tests import torch_threads  # noqa: F401  (one pool a worker)

STL10_EQ = jimages.SPECS["stl10"].default_equivalence
NON_AFFINE = ["hflip", "vflip", "D4_group", "color", "gray", "resize_crop",
              "erasing"]
ATOL = {"hflip": 1e-6, "vflip": 1e-6, "D4_group": 1e-6, "gray": 1e-6,
        "erasing": 1e-6, "color": 1e-5, "resize_crop": 2e-5}
SHAPES = [(6, 96, 96, 3), (5, 13, 11, 3)]
CHAIN_ATOL = 8e-5


def _batch(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bern(key, p, b):
    return _t(jax.random.bernoulli(key, p, (b, 1, 1, 1)).reshape(b))


def _unif(key, b, lo=0.0, hi=1.0, shape=None):
    return _t(jax.random.uniform(key, shape or (b,), minval=lo,
                                 maxval=hi).reshape(b))


def _crop_draws(key, b, scale=(0.3, 1.0), ratio=(0.7, 1.4)) -> dict:
    """What `random_resized_crop(key, batch, scale, ratio)` draws."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"area": _unif(k1, b, *scale),
            "log_r": _unif(k2, b, jnp.log(ratio[0]), jnp.log(ratio[1])),
            "u_y": _unif(k3, b), "u_x": _unif(k4, b)}


def _affine_draws(key, shape, degrees=0.0, translate=(0.0, 0.0),
                  scale=(1.0, 1.0), shear=0.0) -> dict:
    """What `_rand_affine(key, batch, ...)` draws."""
    b, h, w, _ = shape
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {"angle": _t(jnp.deg2rad(jax.random.uniform(
                k1, (b,), minval=-degrees, maxval=degrees))),
            "tx": _unif(k2, b, -translate[0], translate[0]) * w,
            "ty": _unif(k3, b, -translate[1], translate[1]) * h,
            "scale": _unif(k4, b, *scale),
            "shear": _t(jnp.deg2rad(jax.random.uniform(
                k5, (b,), minval=-shear, maxval=shear)))}


def jax_draws(name: str, key, shape) -> dict:
    """The draws of JAX's augmentation `name` (its registry function, at
    its defaults) under `key`, in the port's form."""
    b = shape[0]
    if name in ("hflip", "vflip"):
        return {"flip": _bern(key, 0.5, b)}
    if name == "D4_group":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"hflip": _bern(k1, 0.5, b), "vflip": _bern(k2, 0.5, b),
                "rot": _bern(k3, 0.5, b)}
    if name == "color":
        k0, k1, k2, k3, k4 = jax.random.split(key, 5)
        s4 = (b, 1, 1, 1)
        return {"apply": _bern(k0, 0.8, b),
                "brightness": 1 + _unif(k1, b, -0.4, 0.4, s4),
                "contrast": 1 + _unif(k2, b, -0.4, 0.4, s4),
                "saturation": 1 + _unif(k3, b, -0.4, 0.4, s4),
                "hue": _unif(k4, b, -0.2, 0.2, s4)}
    if name == "gray":
        return {"apply": _bern(key, 0.2, b)}
    if name == "resize_crop":
        return _crop_draws(key, b)
    if name == "erasing":
        k0, k1, k2, k3 = jax.random.split(key, 4)
        return {"apply": _bern(k0, 0.5, b), "area": _unif(k1, b, 0.02, 0.33),
                "u_y": _unif(k2, b), "u_x": _unif(k3, b)}
    raise KeyError(name)


def jax_chain_draws(equivalence, key, shape) -> list:
    """JAX `make_augmenter(equivalence)(key, batch)`'s draws: one key of
    `split(key, n)` per function, the merged affine first."""
    affine = [n for n in equivalence if n in jaug._AFFINE_PARAMS]
    names = (["affine"] if affine else []) + [
        n for n in equivalence if n not in jaug._AFFINE_PARAMS]
    keys = jax.random.split(key, max(1, len(names)))
    return [_affine_draws(k, shape, **jaug._merged_affine(affine).keywords)
            if n == "affine" else jax_draws(n, k, shape)
            for n, k in zip(names, keys)]


@pytest.mark.parametrize("shape", SHAPES, ids=["96px", "odd"])
@pytest.mark.parametrize("name", NON_AFFINE)
def test_each_augmentation_matches_jax(name, shape):
    if name == "D4_group":   # square images only, as in JAX
        shape = shape[:2] + (shape[1], 3)
    x = _batch(shape, 1)
    key = jax.random.key(7)
    want = np.asarray(jaug._REGISTRY[name](key, jnp.asarray(x)))
    aug = taug._REGISTRY[name]
    got = aug.apply(torch.from_numpy(x), jax_draws(name, key, shape))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL[name],
                               err_msg=name)
    # the port's own draw applies to the same shapes
    own = aug(torch.Generator().manual_seed(0), torch.from_numpy(x))
    assert own.shape == want.shape


@pytest.mark.parametrize("where", ["identity", "far_corner", "smallest"])
def test_resize_crop_edges_match_jax(where):
    """The identity crop (area 1, ratio 1), a crop at the far corner
    (u = 1 - 2^-24) and the smallest, narrowest crop."""
    shape = (3, 96, 96, 3)
    x = _batch(shape, 2)
    b = shape[0]
    one = np.nextafter(np.float32(1), np.float32(0))
    area, log_r, u = {"identity": (1.0, 0.0, 0.0),
                      "far_corner": (0.3, np.log(1.4), one),
                      "smallest": (0.3, np.log(0.7), 0.5)}[where]
    draw = {k: torch.full((b,), np.float32(v)) for k, v in dict(
        area=area, log_r=log_r, u_y=u, u_x=u).items()}
    ch = np.minimum(np.sqrt(area / np.exp(log_r)), 1.0).astype(np.float32)
    cw = np.minimum(np.sqrt(area * np.exp(log_r)), 1.0).astype(np.float32)
    y0, x0 = u * (1 - ch) * 96, u * (1 - cw) * 96

    def one_img(img):
        return jax.image.scale_and_translate(
            img, (96, 96, 3), (0, 1), jnp.array([1 / ch, 1 / cw]),
            jnp.array([-y0 / ch, -x0 / cw]), method="linear")

    want = np.asarray(jax.vmap(one_img)(jnp.asarray(x)))
    got = taug.ResizedCrop.apply(torch.from_numpy(x), draw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if where == "identity":
        np.testing.assert_allclose(got, x, atol=2e-5)


@pytest.mark.parametrize("equivalence", [
    STL10_EQ, ("rotation", "hflip", "scale--", "color", "erasing"),
    ("vflip", "gray", "resize_crop"), ("D4_group", "x_translation")])
def test_make_augmenter_chain_matches_jax(equivalence):
    """The chain: the merged affine first, then the others in the order
    named, each on its key of JAX's split."""
    side = 96 if equivalence == STL10_EQ else 24
    shape = (5, side, side, 3)
    x = _batch(shape, 3)
    key = jax.random.key(11)
    want = np.asarray(jaug.make_augmenter(equivalence)(key, jnp.asarray(x)))
    aug = taug.make_augmenter(equivalence)
    affine = [n for n in equivalence if n in taug._AFFINE_PARAMS]
    assert [type(m).__name__ for m in aug.members][:1] == \
        (["Affine"] if affine else [type(taug._REGISTRY[equivalence[0]])
                                    .__name__])
    got = aug.apply(torch.from_numpy(x),
                    jax_chain_draws(equivalence, key, shape))
    np.testing.assert_allclose(got.numpy(), want, atol=CHAIN_ATOL)
    assert taug.build_augmenter(equivalence) == aug
    with pytest.raises(ValueError, match="draws"):
        aug.apply(torch.from_numpy(x), [])


def _within(frac: float, p: float, n: int) -> bool:
    return abs(frac - p) <= 5 * np.sqrt(p * (1 - p) / n)


def test_the_ports_draws_keep_jaxs_ranges_and_probabilities():
    n = 20000
    shape = (n, 96, 96, 3)
    g = torch.Generator().manual_seed(0)
    for name, key, p in (("hflip", "flip", 0.5), ("vflip", "flip", 0.5),
                         ("gray", "apply", 0.2), ("color", "apply", 0.8),
                         ("erasing", "apply", 0.5)):
        d = taug._REGISTRY[name].draw(g, shape)
        assert d[key].dtype == torch.bool and d[key].shape == (n,)
        assert _within(d[key].float().mean().item(), p, n), name
    d4 = taug.D4Group().draw(g, shape)
    assert all(_within(d4[k].float().mean().item(), 0.5, n) for k in d4)
    c = taug.ColorJitter().draw(g, shape)
    for k, (lo, hi) in dict(brightness=(0.6, 1.4), contrast=(0.6, 1.4),
                            saturation=(0.6, 1.4), hue=(-0.2, 0.2)).items():
        v = c[k].numpy()
        assert lo <= v.min() < v.max() <= hi and v.max() - v.min() > \
            0.99 * (hi - lo), k
    r = taug.ResizedCrop().draw(g, shape)
    assert 0.3 <= r["area"].min() and r["area"].max() <= 1.0
    assert np.log(0.7) - 1e-6 <= r["log_r"].min() and \
        r["log_r"].max() <= np.log(1.4) + 1e-6
    assert abs(r["log_r"].mean().item()) < 0.01
    e = taug.Erasing().draw(g, shape)
    assert 0.02 <= e["area"].min() and e["area"].max() <= 0.33
    for d in (r, e):
        for k in ("u_y", "u_x"):
            assert 0 <= d[k].min() and d[k].max() < 1
            assert abs(d[k].mean().item() - 0.5) < 0.01
    # the chain's draw is the members' draws, in order
    chain = taug.make_augmenter(STL10_EQ)
    draws = chain.draw(g, (4, 96, 96, 3))
    assert [set(d) for d in draws] == [
        {"flip"}, {"area", "log_r", "u_y", "u_x"},
        {"apply", "brightness", "contrast", "saturation", "hue"},
        {"apply"}]


def test_available_augmentations_and_unknown_names():
    assert taug.available_augmentations() == jaug.available_augmentations()
    assert set(taug._REGISTRY) == set(jaug._REGISTRY)
    with pytest.raises(KeyError):
        taug.make_augmenter(["hflip", "no_such"])


def test_erasing_and_gray_fill_as_jax_does():
    """Erasing fills a rectangle with 0.5 whose sides truncate toward
    zero; grayscale puts the luminance in the three channels."""
    x = torch.from_numpy(_batch((2, 10, 10, 3), 4))
    d = {"apply": torch.tensor([True, False]),
         "area": torch.tensor([0.3, 0.3]), "u_y": torch.tensor([0.99, 0.]),
         "u_x": torch.tensor([0.0, 0.])}
    out = taug.Erasing().apply(x, d)
    # side int32(sqrt(0.3) * 10) = 5, corner int32(0.99 * 5) = 4
    assert torch.all(out[0, 4:9, 0:5] == 0.5)
    assert torch.equal(out[0, :4], x[0, :4]) and torch.equal(out[1], x[1])
    g = taug.Grayscale.apply(x, {"apply": torch.tensor([True, False])})
    assert torch.equal(g[0, ..., 0], g[0, ..., 2]) and torch.equal(g[1], x[1])


# ---------------------------------------------------------------------------
# label_augment: EquivariantRandomResizedCrop
# ---------------------------------------------------------------------------

LABEL_EQ = dict(invariant_scale=(0.6, 0.9), equivariant_scale=(0.3, 1.0),
                p=0.7)


def jax_label_draws(kw: dict, key, b: int, n_classes: int) -> dict:
    """What JAX's `EquivariantRandomResizedCrop(...)(key, batch, y)`
    draws, in the port's form."""
    m = jlabel.EquivariantRandomResizedCrop(num_classes=n_classes, **kw)
    k_range, k_l, k_i, k_r, k_flip, k_newy = jax.random.split(key, 6)
    eq, inv = m.equivariant_scale, m.invariant_scale
    return {"which": _t(jax.random.choice(k_range, 3, (b,),
                                          p=m.range_probs)).long(),
            "crops": [_crop_draws(k, b, s, m.ratio) for k, s in (
                (k_l, (eq[0], inv[0])), (k_i, (inv[0], inv[1])),
                (k_r, (inv[1], eq[1])))],
            "flip": _t(jax.random.bernoulli(k_flip, m.p, (b,))),
            "new_y": _t(jax.random.randint(k_newy, (b,), 0, n_classes,
                                           dtype=jnp.int32)).long()}


@pytest.mark.parametrize("kw", [LABEL_EQ, {}], ids=["custom", "default"])
def test_equivariant_crop_matches_jax(kw):
    b = 16
    x = _batch((b, 40, 40, 3), 5)
    y = np.random.default_rng(6).integers(0, 10, b).astype(np.int32)
    key = jax.random.key(13)
    jm = jlabel.EquivariantRandomResizedCrop(num_classes=10, **kw)
    want_x, want_y = jm(key, jnp.asarray(x), jnp.asarray(y))
    tm = tlabel.EquivariantRandomResizedCrop(num_classes=10, **kw)
    assert np.allclose(tm.range_probs, np.asarray(jm.range_probs))
    d = jax_label_draws(kw, key, b, 10)
    got_x, got_y = tm.apply(torch.from_numpy(x),
                            torch.from_numpy(y).long(), d)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=2e-5)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    # the draw really resamples some labels and keeps the invariant ones
    kept = d["which"].numpy() == 1
    np.testing.assert_array_equal(got_y.numpy()[kept], y[kept])


def test_equivariant_crop_range_check_and_its_draws():
    with pytest.raises(ValueError, match="contain the invariant"):
        tlabel.EquivariantRandomResizedCrop(invariant_scale=(0.2, 1.0),
                                            equivariant_scale=(0.3, 1.0))
    with pytest.raises(ValueError, match="contain the invariant"):
        jlabel.EquivariantRandomResizedCrop(invariant_scale=(0.2, 1.0),
                                            equivariant_scale=(0.3, 1.0))
    m = tlabel.EquivariantRandomResizedCrop(num_classes=7, **LABEL_EQ)
    n = 20000
    d = m.draw(torch.Generator().manual_seed(1), (n, 8, 8, 3))
    freq = np.bincount(d["which"].numpy(), minlength=3) / n
    for f, p in zip(freq, m.range_probs):
        assert _within(f, p, n)
    assert _within(d["flip"].float().mean().item(), 0.7, n)
    assert d["new_y"].min() == 0 and d["new_y"].max() == 6
    for c, (lo, hi) in zip(d["crops"], ((0.3, 0.6), (0.6, 0.9),
                                        (0.9, 1.0))):
        assert lo <= c["area"].min() and c["area"].max() <= hi


# ---------------------------------------------------------------------------
# The image datasets: batches() and the device sampler
# ---------------------------------------------------------------------------

AT = ["input", "representative", "equiv_x"]


def _datasets(at, normalize, name="stl10", n=40, **extra):
    kw = dict(name=name, synthetic=True, synthetic_n=n, additional_target=at,
              is_normalize=normalize, **extra)
    jds, tds = jimages.ImageDataset(**kw), timages.ImageDataset(**kw)
    assert jds.data.tobytes() == tds.data.tobytes()
    return jds, tds


def _assert_batches_equal(want, got, normalize):
    for name, w, g in zip(("x", "y", "aux"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, name
        np.testing.assert_allclose(
            g, w, atol=CHAIN_ATOL * (1 + 3 * normalize), err_msg=name)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("at", AT)
def test_batches_match_jax_on_jaxs_draws(at, normalize):
    """JAX's `batches(seed)` with the STL10 chain and a
    `label_equivalence`, and the port's `build` on the same images and
    JAX's draws (its key: x's split, then the label augmentation's, then
    an equiv_x positive's)."""
    B, seed = 6, 3
    jds, tds = _datasets(at, normalize, label_equivalence=LABEL_EQ)
    want = next(jds.batches(B, seed=seed))
    idx = np.random.default_rng(seed).permutation(len(tds))[:B]
    raw = torch.from_numpy(tds.data[idx]).float() / 255.0
    y = torch.from_numpy(tds.targets[idx])
    shape = tuple(raw.shape)
    key = jax.random.key(seed)
    key, k1 = jax.random.split(key)
    key, k3 = jax.random.split(key)
    key, k2 = jax.random.split(key)
    got = tds.build(raw, y, jax_chain_draws(STL10_EQ, k1, shape),
                    jax_label_draws(LABEL_EQ, k3, B, 10),
                    jax_chain_draws(STL10_EQ, k2, shape)
                    if at == "equiv_x" else None)
    _assert_batches_equal(want, got, normalize)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("at", AT)
def test_device_sampler_matches_jax_on_jaxs_draws(at, normalize):
    """JAX's `device_sampler(B)(key)` and the port's sampler `build` on
    JAX's indices and draws (split(key, 4): indices, x, positive,
    labels), on the unlabeled split too."""
    B = 8
    jds, tds = _datasets(at, normalize, label_equivalence=LABEL_EQ,
                         train_split="unlabeled")
    key = jax.random.key(5)
    want = jds.device_sampler(B)(key)
    k_idx, k_aug, k_aux, k_lab = jax.random.split(key, 4)
    idx = torch.from_numpy(np.asarray(
        jax.random.randint(k_idx, (B,), 0, len(jds)), np.int64))
    shape = (B, *tds.spec.shape)
    sampler = tds.device_sampler(B)
    got = sampler.build(idx, jax_chain_draws(STL10_EQ, k_aug, shape),
                        jax_chain_draws(STL10_EQ, k_aux, shape)
                        if at == "equiv_x" else None,
                        jax_label_draws(LABEL_EQ, k_lab, B, 10))
    _assert_batches_equal(want, got, normalize)
    # its own draws: shapes and dtypes
    x, y, aux = sampler(torch.Generator().manual_seed(0))
    assert x.shape == shape and x.dtype == torch.float32
    assert y.shape == (B,) and y.dtype == torch.int64


def test_batches_draw_from_the_epochs_generator():
    """`batches(seed)` draws x's chain, the label augmentation, then the
    positive's chain from a generator seeded with `seed`; without
    augmentation the images are the raw ones and the labels kept."""
    _, tds = _datasets("equiv_x", False, n=30, label_equivalence=LABEL_EQ)
    x, y, pos = next(tds.batches(6, seed=4))
    idx = np.random.default_rng(4).permutation(len(tds))[:6]
    raw = torch.from_numpy(tds.data[idx]).float() / 255.0
    labels = torch.from_numpy(tds.targets[idx])
    g = torch.Generator().manual_seed(4)
    want = tds.build(raw, labels, *tds.draws(g, raw.shape))
    for w, t in zip(want, (x, y, pos)):
        assert torch.equal(w, t)
    assert not torch.allclose(x, pos)
    tds.is_augment = False
    x0, y0, pos0 = next(tds.batches(6, seed=4))
    assert torch.equal(x0, raw) and torch.equal(pos0, raw)
    assert torch.equal(y0, labels)
    assert tds.augmenter() is None and tds.label_augmenter() is None
