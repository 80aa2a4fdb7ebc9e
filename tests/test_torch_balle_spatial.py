"""BALLE, GDN and the spatial hyperprior on the port against the JAX
package.

* `GDN` forward and inverse against flax's on numpy-seeded inputs and
  parameters, some of `beta_sqrt` below its lower bound: rtol 1e-5 on the
  outputs (fp32 einsum and rsqrt), gradients rtol 1e-4 / atol 1e-5 of the
  largest entry (tests/test_pallas_eb.py's gradient tolerance);
* `BalleEncoder` / `BalleDecoder` at 32 and 96 px (the 96 -> 128 -> 96
  resizes), fp32 and bf16, train and eval mode, relu and GDN, on weights
  carried from flax by `compressor_params_from_flax`: fp32 rtol 1e-4 /
  atol 1e-5 of the largest entry (the convolutions sum in another order),
  bf16 atol 2e-2 of the largest entry (tests/test_flash_attn.py's bf16
  tolerance); the BatchNorm statistics after a train-mode forward too;
* `HRateHyperpriorSpatial` values, rates, logs and gradients with JAX's
  noise handed in (tests/test_torch_hyperprior.py's tolerances: values
  rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 of the largest entry), K3's
  path (plain on the CPU) and the reference chain;
* `SpatialHyperpriorCoder` byte for byte on `tests/golden/
  streams_spatial.npz` (streams, lengths, z_hat) from the file's own
  params, on JAX's coder's streams from fresh params, and its round trip
  against the eval-mode forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors import rates as jrates
from lossyless_tpu.nn import cnn as jcnn
from lossyless_tpu.nn import layers as jlayers
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.nn import layers as tlayers
from lossyless_tpu_torch.nn import registry
from tests import torch_threads  # noqa: F401  (one pool a worker)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, scale, a.shape).astype(np.float32), tree)


def _close(got, want, dtype="float32", rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    top = max(1.0, np.abs(want).max())
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=2e-2 * top)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * top)


# ---------------------------------------------------------------------------
# GDN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["nhwc", "vector"])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_flax(inverse, layout):
    c = 6
    shape = (3, 5, 4, c) if layout == "nhwc" else (7, c)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = jlayers.GDN(inverse=inverse)
    params = _perturb(jm.init(jax.random.key(0), jnp.asarray(x))["params"],
                      1, 0.1)
    # some of beta_sqrt under its lower bound (1e-6 ** 0.5)
    params["beta_sqrt"][:2] = [1e-4, -0.5]
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    def jloss(p, xx):
        out = jm.apply({"params": p}, xx)
        return jnp.sum(out * w), out

    (_, want), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tm = tlayers.get_activation("gdn", inverse=inverse)(c)
    tm.load_state_dict(tlayers.params_from_flax(params))
    # the port takes the channels on dim 1: NCHW or (batch, features)
    perm = (0, 3, 1, 2) if layout == "nhwc" else (0, 1)
    tx = torch.from_numpy(x).permute(perm).contiguous().requires_grad_()
    out = tm(tx)
    (out * torch.from_numpy(w).permute(perm)).sum().backward()
    back = (0, 2, 3, 1) if layout == "nhwc" else (0, 1)
    np.testing.assert_allclose(out.detach().permute(back).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-7)
    for name, g in (("beta_sqrt", jg["beta_sqrt"]),
                    ("gamma_sqrt", jg["gamma_sqrt"])):
        _close(getattr(tm, name).grad.numpy(), g)
    _close(tx.grad.permute(back).numpy(), jgx)
    # bf16 in, bf16 out: the normalizer is computed in fp32
    xb = torch.from_numpy(x).permute(perm).to(torch.bfloat16)
    assert tm(xb).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# BALLE encoder and decoder
# ---------------------------------------------------------------------------


def _carry(enc_vars, dec_vars):
    """Both networks' flax variables through `compressor_params_from_flax`
    (as an encoder and a direct distortion's decoder), split back."""
    tree = {"p_ZlX": {"mapper": enc_vars["params"]},
            "distortion_estimator": {"q_YlZ": dec_vars["params"]}}
    stats = {"p_ZlX": {"mapper": enc_vars.get("batch_stats", {})},
             "distortion_estimator": {
                 "q_YlZ": dec_vars.get("batch_stats", {})}}
    sd = tcomp.compressor_params_from_flax(tree, stats)

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    return part("p_ZlX.mapper."), part("distortion_estimator.q_YlZ.")


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gdn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [32, 96])
def test_balle_matches_flax(side, dtype, activation, training):
    shape = (side, side, 3)
    out_dim = 8 * 4 if side == 32 else 8 * 64   # 2x2 or 8x8 positions
    kw = dict(hid_dim=8, activation=activation, dtype=dtype)
    x = np.random.default_rng(3).uniform(0, 1, (3, *shape)).astype(
        np.float32)
    z = np.random.default_rng(4).normal(size=(3, out_dim)).astype(np.float32)
    je = jcnn.BalleEncoder(out_dim=out_dim, in_shape=shape, **kw)
    jd = jcnn.BalleDecoder(out_shape=shape, in_dim=out_dim, **kw)
    ev = je.init(jax.random.key(0), jnp.asarray(x))
    dv = jd.init(jax.random.key(1), jnp.asarray(z))
    ev, dv = ({"params": _perturb(v["params"], 5 + i),
               "batch_stats": v["batch_stats"]} for i, v in enumerate(
                  (ev, dv)))
    te = registry.get_architecture("balle", shape, out_dim, **kw)
    td = registry.get_architecture("balle", out_dim, shape, **kw)
    assert te.channel_out_dim == 8
    enc_sd, dec_sd = _carry(ev, dv)
    te.load_state_dict(enc_sd)
    td.load_state_dict(dec_sd)
    if activation == "gdn":
        assert "GDN_2.gamma_sqrt" in enc_sd and "GDN_2.beta_sqrt" in dec_sd
    for jm, tm, v, inp in ((je, te, ev, x), (jd, td, dv, z)):
        want, new = jm.apply(v, jnp.asarray(inp), training=training,
                             mutable=["batch_stats"])
        got = tm(torch.from_numpy(inp), training=training)
        assert got.dtype == torch.float32
        _close(got.detach().numpy(), np.asarray(want), dtype)
        if training and dtype == "float32":
            moved = {"params": v["params"], **new}
            want_sd = _carry(ev, moved)[1] if tm is td \
                else _carry(moved, dv)[0]
            for k, w in want_sd.items():
                if k.endswith((".mean", ".var")):
                    _close(tm.state_dict()[k].numpy(), w.numpy())


def test_balle_latent_layout_and_refusal():
    """The last conv's channels over the grid, flattened (H, W, C); an
    out_dim the positions do not divide raises, as JAX's does."""
    enc = registry.get_architecture("balle", (96, 96, 3), 8 * 64,
                                    hid_dim=4)
    assert enc.size == (128, 128) and enc.resize
    assert [c.kernel.shape[0] for c in enc.convs] == [4, 4, 4, 8]
    assert enc.convs[-1].bias is not None and enc.convs[0].bias is None
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(0))
    z = enc(x)
    feat = enc.convs[-1]
    assert z.shape == (2, 512) and feat.kernel.shape[:2] == (8, 4)
    with pytest.raises(ValueError, match="divisible"):
        registry.get_architecture("balle", (96, 96, 3), 100)
    with pytest.raises(ValueError, match="divisible"):
        jcnn.BalleEncoder(out_dim=100, in_shape=(96, 96, 3)).channel_out_dim


# ---------------------------------------------------------------------------
# The spatial hyperprior
# ---------------------------------------------------------------------------

Z_DIM, C, SIDE, B = 64, 4, 3, 5     # 4 x 4 positions of 4 channels


def _spatial_setup(use_pallas=False):
    z = (np.random.default_rng(8).normal(size=(B, Z_DIM)) * 3).astype(
        np.float32)
    cfg = dict(mode="H_spatial", n_channels=C, side_z_dim=SIDE,
               eb_use_pallas=use_pallas)
    jm = jrates.HRateHyperpriorSpatial(Z_DIM, C, jrates.RateConfig(**cfg))
    v = jm.init({"params": jax.random.key(1)}, jnp.asarray(z), None,
                training=True, rng=jax.random.key(2))
    params = _perturb(v["params"], 9)
    tm = trates.make_rate_estimator(Z_DIM, trates.RateConfig(**cfg))
    tm.load_state_dict(tlayers.params_from_flax(params))
    return z, jm, params, tm


def _folded_noise(key, rows):
    """The inner hyperprior's two draws (side, then z) over the folded
    rows, as `HRateHyperprior` splits its key."""
    r1, r2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(
        r, s, jnp.float32, -0.5, 0.5))) for r, s in ((r1, (rows, SIDE)),
                                                      (r2, (rows, C))))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_spatial_rate_matches_jax(training, use_pallas):
    z, jm, params, tm = _spatial_setup(use_pallas)
    assert isinstance(tm, trates.HRateHyperpriorSpatial)
    key = jax.random.key(3)
    w = np.random.default_rng(10).normal(size=B).astype(np.float32)

    def jloss(p, zz):
        z_hat, rates, logs = jm.apply({"params": p}, zz, None,
                                      training=training, rng=key)
        return jnp.sum(rates * w) + jnp.sum(z_hat ** 2), (z_hat, rates,
                                                          logs)

    (_, (jz_hat, jr, jlogs)), (jg, jgz) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_()
    tz_hat, tr, tlogs = tm(tz, None, training=training,
                           noise=_folded_noise(key, B * 16))
    ((tr * torch.from_numpy(w)).sum() + (tz_hat ** 2).sum()).backward()
    assert tz_hat.shape == (B, Z_DIM) and tr.shape == (B,)
    np.testing.assert_allclose(tz_hat.detach().numpy(), np.asarray(jz_hat),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr),
                               rtol=1e-5)
    assert set(tlogs) == set(jlogs)
    for k in ("H_q_ZlS", "H_q_Z", "H_q_S"):
        assert float(tlogs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5)
    want = tlayers.params_from_flax(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n, g in want.items():
        tg = torch.zeros(g.shape) if got[n] is None else got[n]
        _close(tg.numpy(), g.numpy())
    _close(tz.grad.numpy(), np.asarray(jgz))


def test_spatial_fold_is_channel_major():
    """(B, C * H * W) -> (B * H * W, C): row b * HW + p holds the C
    channels of position p of sample b; the unfold inverts it."""
    z = torch.arange(2 * 3 * 4).reshape(2, 12).float()
    rows = trates.fold_spatial(z, 3)
    assert rows.shape == (8, 3)
    assert rows[5].tolist() == [z[1, 1].item(), z[1, 5].item(),
                                z[1, 9].item()]
    assert torch.equal(trates.unfold_spatial(rows, 2), z)
    assert np.array_equal(trates.fold_spatial(z.numpy(), 3), rows.numpy())


def _golden():
    from tests.test_golden_streams import _fixture_variables, _load_grouped

    f, streams = _load_grouped("streams_spatial.npz")
    return f, streams, _fixture_variables(f)


def test_spatial_coder_reproduces_golden_streams():
    f, golden, variables = _golden()
    tm = trates.make_rate_estimator(64, trates.RateConfig(
        mode="H_spatial", n_channels=4, side_z_dim=3))
    tm.load_state_dict(tlayers.params_from_flax(variables["params"]))
    coder = trates.SpatialHyperpriorCoder(tm)
    streams = coder.compress(f["z"])
    assert len(streams) == len(golden) == 2
    for grp, ggrp in zip(streams, golden):
        assert [len(s) for s in grp] == [len(s) for s in ggrp]
        assert [bytes(s) for s in grp] == [bytes(s) for s in ggrp]
    np.testing.assert_array_equal(
        coder.decompress(golden, batch_size=len(f["z"])), f["z_hat"])
    np.testing.assert_array_equal(coder.decompress(golden), f["z_hat"])


def test_spatial_coder_matches_jax_and_round_trips():
    """Fresh params off their init: the port's streams are JAX's coder's,
    and the decode is the eval-mode forward's z_hat (the dequantized
    latent) to 1e-5."""
    z, jm, params, tm = _spatial_setup()
    want = jrates.SpatialHyperpriorCoder(jm, params).compress(z)
    coder = trates.SpatialHyperpriorCoder(tm)
    got = coder.compress(z)
    assert got == want
    assert len(got[0]) == len(got[1]) == B * 16
    decoded = coder.decompress(got)
    with torch.no_grad():
        z_hat, _, _ = tm(torch.from_numpy(z), None, training=False)
    np.testing.assert_allclose(decoded, z_hat.numpy(), rtol=1e-5, atol=1e-5)
