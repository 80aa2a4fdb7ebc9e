"""The image networks of the port against flax: the group norm, the
ResNets, the pyramid CNN and its transposed decoder.

The same numpy-seeded inputs go through the JAX modules and the port's,
with JAX's weights (every coefficient moved off its init, BatchNorm running
statistics too) carried over by `layers.params_from_flax`. Tolerances:
fp32 rtol 1e-4 / atol 1e-5 of the output's largest entry (the sums of a
conv run in another order), bf16 atol 2e-2 (tests/test_flash_attn.py's
bf16 tolerance; both sides round at flax's points). Train mode also holds
the updated running statistics.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lossyless_tpu.nn import cnn as jcnn
from lossyless_tpu.nn import layers as jlayers
from lossyless_tpu.nn import resnet as jresnet
from lossyless_tpu_torch.nn import cnn as tcnn
from lossyless_tpu_torch.nn import layers as tlayers
from lossyless_tpu_torch.nn import registry
from lossyless_tpu_torch.nn import resnet as tresnet
from tests import torch_threads  # noqa: F401  (one pool a worker)


def _moved(tree, rng, scale):
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, scale, a.shape).astype(np.float32), tree)


def _merge(params, stats) -> dict:
    out = dict(params)
    for k, v in stats.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _flax_vars(module, x, seed=0, scale=0.05):
    """flax init on x, every param moved by N(0, scale) and the running
    statistics to mean ~N(0, 0.1), var ~U(0.5, 1.5)."""
    v = module.init(jax.random.key(seed), jnp.asarray(x), training=False)
    rng = np.random.default_rng(seed)
    params = _moved(v["params"], rng, scale)
    stats = v.get("batch_stats", {})
    stats = {k: _stats(s, rng) for k, s in stats.items()}
    return params, stats


def _stats(tree, rng):
    if "mean" in tree and not isinstance(tree["mean"], dict):
        return {"mean": rng.normal(0, 0.1, tree["mean"].shape)
                .astype(np.float32),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape)
                .astype(np.float32)}
    return {k: _stats(v, rng) for k, v in tree.items()}


def _port(module, params, stats):
    module.load_state_dict(tlayers.params_from_flax(_merge(params, stats)))
    return module


def _run_both(jm, tm, x, training, seed=0, scale=0.05):
    """(jax out, port out, jax new stats, port state dict)."""
    params, stats = _flax_vars(jm, x, seed, scale)
    _port(tm, params, stats)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    if training and stats:
        jout, new = jm.apply(variables, jnp.asarray(x), training=True,
                             mutable=["batch_stats"])
        new = new["batch_stats"]
    else:
        jout, new = jm.apply(variables, jnp.asarray(x), training=training), \
            None
    tout = tm(torch.from_numpy(x), training=training)
    return np.asarray(jout, np.float32), tout.detach().float().numpy(), new, \
        tm


def _close(got, want, dtype="float32"):
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, atol=2e-2 * max(
            1.0, np.abs(want).max()))


def _close_stats(tm, new, dtype="float32"):
    sd = tm.state_dict()
    want = tlayers.params_from_flax(new)
    assert want and set(want) <= set(sd)
    for k, v in want.items():
        _close(sd[k].numpy(), v.numpy(), dtype)


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The norms of apply_norm
# ---------------------------------------------------------------------------


class _Norm(fnn.Module):
    norm: str

    @fnn.compact
    def __call__(self, x, *, training=False):
        return jlayers.apply_norm(self.norm, x, training=training)


class _TNorm(torch.nn.Module):
    """The port's norm of the name on an NHWC (or (B, C)) input, under
    flax's module name."""

    def __init__(self, norm, c):
        super().__init__()
        norm = tlayers.make_norm(norm, c)
        self.key = f"{type(norm).__name__}_0"
        self.add_module(self.key, norm)

    def forward(self, x, *, training=False):
        v = x.permute(0, 3, 1, 2) if x.dim() == 4 else x
        y = tlayers.apply_norm(getattr(self, self.key), v, training=training)
        return y.permute(0, 2, 3, 1) if x.dim() == 4 else y


@pytest.mark.parametrize("norm", ["groupnorm", "batchnorm", "layernorm"])
@pytest.mark.parametrize("shape", [(4, 6, 5, 16), (4, 6, 5, 12), (7, 24)])
@pytest.mark.parametrize("training", [True, False])
def test_apply_norm_matches_flax(norm, shape, training):
    """8 groups where the channels divide by 8 (16, 24), else 1 (12)."""
    x = (_image(shape, 1) * 3 - 1).astype(np.float32)
    want, got, new, tm = _run_both(_Norm(norm), _TNorm(norm, shape[-1]), x,
                                   training, scale=0.3)
    _close(got, want)
    if new:
        _close_stats(tm, new)
    if norm == "groupnorm":
        assert tm.GroupNorm_0.groups == (8 if shape[-1] % 8 == 0 else 1)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

BASES = ["resnet18", "resnet34", "resnet50"]
STEMS = {"small": (32, 32, 1), "large": (104, 104, 3)}


def _resnet_pair(base, in_shape, dtype):
    jm = jresnet.ResNet(out_dim=24, in_shape=in_shape, base=base,
                        dtype=dtype)
    tm = registry.get_architecture("resnet", in_shape, 24, base=base,
                                   dtype=dtype)
    return jm, tm


def _resnet_runs(base, stem, dtype, b):
    """JAX and the port in train mode (from the init statistics) and in
    eval mode with each layer's running statistics set to its batch
    statistics of that train pass (recovered from flax's update, new =
    0.9 old + 0.1 batch), so eval sees activations of the scale it was
    trained on. Returns ({mode: (jax out, port out)}, jax's updated
    statistics, the port after its train pass, params, both stats)."""
    in_shape = STEMS[stem]
    x = _image((b, *in_shape), 2)
    jm, tm = _resnet_pair(base, in_shape, dtype)
    v = jm.init(jax.random.key(0), jnp.asarray(x), training=False)
    params = _moved(v["params"], np.random.default_rng(0), 0.05)
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    jt, new = jm.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), training=True, mutable=["batch_stats"])
    new = jax.tree.map(np.asarray, new["batch_stats"])
    batch = jax.tree.map(lambda n, o: (n - 0.9 * o) / 0.1, new, stats)
    je = jm.apply({"params": params, "batch_stats": batch}, jnp.asarray(x),
                  training=False)
    out = {}
    _port(tm, params, stats)
    out["train"] = tm(torch.from_numpy(x), training=True)
    trained = {k: t.clone() for k, t in tm.state_dict().items()}
    _port(tm, params, batch)
    out["eval"] = tm(torch.from_numpy(x), training=False)
    out = {k: (np.asarray(j, np.float32), t.detach().float().numpy())
           for (k, t), j in zip(out.items(), (jt, je))}
    tm.load_state_dict(trained)
    return out, new, tm, x, params, {"train": stats, "eval": batch}


def _jax_float64(base, stem, x, params, stats, training):
    """The flax ResNet evaluated in float64 (JAX's x64 mode, restored
    after), the yardstick of fp32 roundoff: (output, updated stats)."""
    jax.config.update("jax_enable_x64", True)
    try:
        jm = jresnet.ResNet(out_dim=24, in_shape=STEMS[stem], base=base,
                            dtype="float64")
        f64 = functools.partial(jax.tree.map,
                                lambda a: np.asarray(a, np.float64))
        out, new = jm.apply({"params": f64(params),
                             "batch_stats": f64(stats)},
                            jnp.asarray(x, jnp.float64), training=training,
                            mutable=["batch_stats"])
        return np.asarray(out), jax.tree.map(np.asarray, new["batch_stats"])
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("stem", sorted(STEMS))
def test_resnet_matches_flax_fp32(base, stem):
    """Train mode (batch statistics and the updated running ones) and
    eval mode (running statistics) at each base and both stems.

    ResNet-50's 16 bottleneck blocks amplify fp32 roundoff past the
    tolerance: in train mode JAX's output lies 6e-4 (small stem) to 1e-3
    (large) from the same network in float64, the port's 1.1e-4 to
    2.7e-4; in eval mode both ~3.7e-4. There the port is held to the
    float64 network instead, output and updated statistics alike: at most
    1.5 x JAX's own distance from it (phase 3's float64 rule for K1)."""
    out, new, tm, x, params, stats = _resnet_runs(base, stem, "float32", 3)
    if base != "resnet50":
        for want, got in out.values():
            _close(got, want)
        _close_stats(tm, new)
    else:
        sd = tm.state_dict()
        for mode, (want, got) in out.items():
            ref, ref_new = _jax_float64(base, stem, x, params, stats[mode],
                                        mode == "train")
            pairs = [(mode, got, want, ref)]
            if mode == "train":
                flat_ref = tlayers.params_from_flax(ref_new)
                pairs += [(k, sd[k].numpy(), v.numpy(),
                           flat_ref[k].numpy())
                          for k, v in tlayers.params_from_flax(new).items()]
            for name, g, w, r in pairs:
                assert np.abs(g - r).max() <= max(
                    1.5 * np.abs(w - r).max(), 1e-5 * np.abs(r).max()), name
    assert tm.small_input == (stem == "small")


@pytest.mark.parametrize("stem", sorted(STEMS))
def test_resnet18_matches_flax_bf16(stem):
    """The image path's encoder in bf16, both modes: within 2e-2 of the
    output's largest entry (~3.5 here: ~4 bf16 ulps at the output after 18
    layers that each round to bf16 at flax's points)."""
    out, new, tm, *_ = _resnet_runs("resnet18", stem, "bfloat16", 4)
    for want, got in out.values():
        _close(got, want, "bfloat16")
    _close_stats(tm, new, "bfloat16")


def test_resnet_layout_and_no_linear():
    """NHWC in; the conv kernels in torch's layout; is_no_linear gives the
    fp32 pooled features (512 for resnet18, 2048 for resnet50)."""
    x = torch.from_numpy(_image((2, 32, 32, 1)))
    m = tresnet.ResNet(8, (32, 32, 1), is_no_linear=True, dtype="bfloat16")
    y = m(x)
    assert y.shape == (2, 512) and y.dtype == torch.float32
    assert m.Conv_0.kernel.shape == (64, 1, 3, 3)
    m = tresnet.ResNet(8, (32, 32, 1), base="resnet50", is_no_linear=True)
    assert m(x).shape == (2, 2048) and not hasattr(m, "Dense_0")
    names = {k.split(".")[0] for k in tresnet.ResNet(
        8, (32, 32, 1)).state_dict()}
    assert names == {"Conv_0", "BatchNorm_0", "Dense_0"} | {
        f"BasicBlock_{i}" for i in range(8)}


# ---------------------------------------------------------------------------
# The transposed conv and the resize: the two parity hazards
# ---------------------------------------------------------------------------


class _ConvT(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x, *, training=False):
        return fnn.ConvTranspose(self.features, (3, 3), strides=(2, 2),
                                 padding="SAME")(x)


def test_conv_transpose_matches_flax_and_a_permuted_kernel_does_not():
    """flax's ConvTranspose is a correlation of the unflipped kernel over
    the dilated input padded (2, 1); torch's conv_transpose2d with only the
    kernel permuted (padding 1, output_padding 1) pads (1, 2) and flips
    the kernel: it is off by far more than roundoff."""
    x = _image((2, 5, 6, 4), 4) * 2 - 1
    jm = _ConvT(3)
    params, _ = _flax_vars(jm, x, scale=0.3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tlayers.ConvTranspose(4, 3, 3, 2)
    tm.load_state_dict({k.split(".", 1)[1]: v for k, v in
                        tlayers.params_from_flax(params).items()})
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 12, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)

    k = torch.from_numpy(np.asarray(params["ConvTranspose_0"]["kernel"]))
    for kernel in (k.permute(2, 3, 0, 1), k.flip(0, 1).permute(2, 3, 0, 1)):
        naive = F.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), kernel,
            torch.from_numpy(np.asarray(params["ConvTranspose_0"]["bias"])),
            stride=2, padding=1, output_padding=1).permute(0, 2, 3, 1)
        assert np.abs(naive.numpy() - want).max() > 0.1


@pytest.mark.parametrize("src,dst", [(96, 128), (128, 96), (32, 32)])
def test_resize_matches_jax_image_resize(src, dst):
    """`jax.image.resize(..., "bilinear")` antialiases when it shrinks:
    `F.interpolate(antialias=True)` matches it both ways; without
    antialias the shrink is off by far more."""
    x = _image((2, src, src, 3), 5)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3),
                                       "bilinear"))
    v = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tcnn._resize(v, (dst, dst)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if dst < src:
        plain = F.interpolate(v, (dst, dst), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        assert np.abs(plain.numpy() - want).max() > 0.05


# ---------------------------------------------------------------------------
# The pyramid CNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [32, 96])
@pytest.mark.parametrize("norm", ["batchnorm", "groupnorm", "identity"])
def test_cnn_encoder_matches_flax(side, norm):
    """At 96 px the input is resized to 128 first (antialias off: an
    upsample)."""
    in_shape = (side, side, 3)
    x = _image((3, *in_shape), 6)
    for training in (True, False):
        jm = jcnn.CNNEncoder(out_dim=10, in_shape=in_shape, hid_dim=8,
                             norm_layer=norm)
        tm = registry.get_architecture("cnn", in_shape, 10, hid_dim=8,
                                       norm_layer=norm)
        want, got, new, tm = _run_both(jm, tm, x, training)
        _close(got, want)
        if new:
            _close_stats(tm, new)


@pytest.mark.parametrize("side,c", [(32, 1), (96, 3)])
@pytest.mark.parametrize("norm", ["batchnorm", "identity"])
def test_cnn_decoder_matches_flax(side, c, norm):
    """At 96 px the decoder's 128 px output is resized down to 96 (the
    antialiased shrink)."""
    out_shape = (side, side, c)
    z = np.random.default_rng(7).normal(size=(3, 12)).astype(np.float32)
    for training in (True, False):
        jm = jcnn.CNNDecoder(out_shape=out_shape, hid_dim=8, norm_layer=norm)
        tm = registry.get_architecture("cnn", 12, out_shape, hid_dim=8,
                                       norm_layer=norm)
        want, got, new, tm = _run_both(jm, tm, z, training)
        assert got.shape == (3, *out_shape)
        _close(got, want)
        if new:
            _close_stats(tm, new)


@pytest.mark.parametrize("training", [True, False])
def test_cnn_pair_matches_flax_bf16(training):
    """The MNIST path's decoder (hid_dim 32, bf16) and its encoder twin."""
    z = np.random.default_rng(8).normal(size=(4, 16)).astype(np.float32)
    jm = jcnn.CNNDecoder(out_shape=(32, 32, 1), hid_dim=32, dtype="bfloat16")
    tm = registry.get_architecture("cnn", 16, (32, 32, 1), hid_dim=32,
                                   dtype="bfloat16")
    want, got, _, _ = _run_both(jm, tm, z, training)
    _close(got, want, "bfloat16")
    x = _image((4, 32, 32, 1), 9)
    jm = jcnn.CNNEncoder(out_dim=16, in_shape=(32, 32, 1), dtype="bfloat16")
    tm = registry.get_architecture("cnn", (32, 32, 1), 16,
                                   dtype="bfloat16")
    want, got, _, _ = _run_both(jm, tm, x, training)
    _close(got, want, "bfloat16")


def test_registry_refuses_what_is_not_ported():
    """`balle` is ported (tests/test_torch_balle_spatial.py), and so are
    the pretrained towers: `clip_rn50` builds CLIP's ModifiedResNet with
    its pool sized for the input, `simclr` and `swav` a ResNet-50
    (tests/test_torch_clip_resnet.py, tests/test_torch_pretrained_ssl.py);
    an unknown mode still raises."""
    from lossyless_tpu_torch.nn import clip_resnet as tcr

    assert isinstance(registry.get_architecture("balle", (32, 32, 3), 8),
                      tcnn.BalleEncoder)
    rn = registry.get_architecture("clip_rn50", (32, 32, 3), 8, width=16,
                                   layers=(1, 1, 1, 1), heads=4)
    assert isinstance(rn, tcr.ClipResNet)
    assert rn.attnpool.positional_embedding.shape == (2, 512)
    for mode in ("simclr", "swav"):
        m = registry.get_architecture(mode, (32, 32, 3), 8)
        assert isinstance(m, tresnet.ResNet)
        assert len(m.blocks) == 16 and m.Dense_0.kernel.shape == (2048, 8)
    with pytest.raises(ValueError, match="unknown architecture"):
        registry.get_architecture("vgg", (32, 32, 3), 8)
