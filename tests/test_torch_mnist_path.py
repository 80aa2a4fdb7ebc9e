"""The augmented-MNIST path of the port against the JAX package.

* `DirectDistortion`'s image mode (the CNN decoder): the grayscale
  Bernoulli and the colour squared error summed per example, in train mode
  with the decoder's BatchNorm statistics, and its gradient; the
  likelihood's gradient at logit 0 (JAX's `abs` and `maximum` ties);
* `load_pretrained_encoder` on a `save_weights` export and on a flat
  `.npz` in JAX's layout;
* one `mnist_vic` training step of the whole compressor (ResNet-18
  encoder, the hyperprior rate, the CNN decoder, the online probe; fp32,
  narrow widths) from JAX's weights on the same batch and noise: logs and
  updated variables at rtol 1e-4;
* a short `main` of each of the six MNIST presets (the staggered pair
  chained through `encoder.pretrained_path`), writing JAX's results-CSV
  keys, and the experiment CLI.
Tolerances: fp32 rtol 1e-4 (the convolutions sum in another order), atol
1e-5 of the largest entry.
"""

import csv
import dataclasses
import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lossyless_tpu.compressors import distortions as jdist
from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import distortions as tdist
from lossyless_tpu_torch.data import augmentations as taug
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.nn import layers as tlayers
from lossyless_tpu_torch.nn import pretrained as tpre
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train import state as tstate

PRESETS = ["mnist_vic", "augmnist_RD", "augmnist_aug", "augmnist_aug_warm",
           "mnist_stag_step1", "mnist_stag_step2"]


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# DirectDistortion's image mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("training", [True, False])
def test_direct_distortion_image_mode_matches_jax(channels, training):
    y_shape, z_dim, B = (32, 32, channels), 12, 5
    rng = np.random.default_rng(channels)
    z = rng.normal(size=(B, z_dim)).astype(np.float32)
    target = rng.uniform(0, 1, (B, *y_shape)).astype(np.float32)
    cfg = dict(mode="direct", data_mode="image", arch_kwargs=dict(hid_dim=8))
    jm = jdist.DirectDistortion(z_dim, y_shape, jdist.DistortionConfig(**cfg))
    v = jm.init(jax.random.key(0), jnp.asarray(z), jnp.asarray(target))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])

    def jloss(zz):
        out, new = jm.apply({"params": params, "batch_stats": stats}, zz,
                            jnp.asarray(target), training=training,
                            mutable=["batch_stats"])
        return out[0].sum(), (out, new)

    (_, ((want, jlogs), new)), jgrad = jax.value_and_grad(
        jloss, has_aux=True)(jnp.asarray(z))
    tm = tdist.make_distortion_estimator(tdist.DistortionConfig(**cfg),
                                         z_dim, y_shape)
    tm.load_state_dict(tlayers.params_from_flax(
        tcomp._merge_stats(params, stats)))
    tz = torch.tensor(z, requires_grad=True)
    got, tlogs = tm(tz, torch.from_numpy(target), training=training)
    got.sum().backward()
    assert got.shape == (B,)
    _close(got.detach().numpy(), np.asarray(want))
    _close(float(tlogs["H_q_TlZ"].detach()), float(jlogs["H_q_TlZ"]))
    _close(tz.grad.numpy(), np.asarray(jgrad))
    if training:   # the decoder's running statistics
        sd = tm.state_dict()
        for k, w in tlayers.params_from_flax(new["batch_stats"]).items():
            _close(sd[k].numpy(), w.numpy())
    # reconstruct: the sigmoid of the decoder's eval-mode output
    rec = tm.reconstruct(torch.from_numpy(z)).detach().numpy()
    jrec = jm.apply({"params": params, "batch_stats": new["batch_stats"]},
                    jnp.asarray(z), method=jm.reconstruct)
    _close(rec, np.asarray(jrec))
    assert rec.min() >= 0 and rec.max() <= 1


def test_bce_gradient_at_logit_zero_is_jaxs():
    """At logit 0 JAX's form gives 1/2 - t - 1/2 (d max = 1/2, d|x| = 1);
    the analytic BCE gradient is 1/2 - t."""
    logits = np.array([0.0, 0.0, 0.0, -1.5, 2.0], np.float32)
    t = np.array([0.3, 0.0, 1.0, 0.3, 0.7], np.float32)
    want = np.asarray(jax.grad(lambda x: jdist._bce_with_logits(
        x, jnp.asarray(t)).sum())(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    tdist._bce_with_logits(x, torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    assert want[0] == pytest.approx(-0.3)
    x2 = torch.tensor(logits, requires_grad=True)
    F.binary_cross_entropy_with_logits(x2, torch.from_numpy(t),
                                       reduction="sum").backward()
    assert x2.grad[0] == pytest.approx(0.2)
    np.testing.assert_allclose(x2.grad.numpy()[3:], want[3:], rtol=1e-5)


# ---------------------------------------------------------------------------
# One mnist_vic step of the whole compressor
# ---------------------------------------------------------------------------

SMALL = ["encoder.z_dim=16", "distortion.arch_kwargs.hid_dim=8",
         "online.arch_kwargs.hid_dim=16", "trainer.precision=fp32",
         "data_feat.kwargs.synthetic=True", "data_feat.kwargs.synthetic_n=64"]
B = 8


def _one_ulp(tree, seed: int):
    """Every value of a flax tree moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        return np.where(rng.integers(0, 2, a.shape) == 1,
                        np.nextafter(a, np.inf), np.nextafter(a, -np.inf)
                        ).astype(a.dtype)
    return jax.tree.map(move, tree)


def _jax_pair_noise(key, side, z_dim):
    r1, r2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(
        r, s, jnp.float32, -0.5, 0.5))) for r, s in ((r1, (B, side)),
                                                      (r2, (B, z_dim))))


@functools.lru_cache(maxsize=None)
def _one_step():
    jcfg = jconfig.apply_overrides(jconfig.preset("mnist_vic"), SMALL)
    tcfg = tconfig.apply_overrides(tconfig.preset("mnist_vic"), SMALL)
    ds = trun.instantiate_datamodule(tcfg, tcfg.data_feat)
    jcfg.in_shape, jcfg.target_shape, jcfg.aux_shape = \
        tcfg.in_shape, tcfg.target_shape, tcfg.aux_shape
    batch = tuple(t.numpy() for t in next(ds.batches(B, seed=0)))
    model = JLC(jcfg.compressor_config())
    opts = [jstate.bind_schedule_steps(o, 1, 1)
            for o in (jcfg.optimizer_feat, jcfg.optimizer_online,
                      jcfg.optimizer_coder)]
    state0 = jstate.TrainState.create(
        model, tuple(map(jnp.asarray, batch)), jax.random.key(1),
        main=opts[0], online=opts[1], coder=opts[2])
    start = (jax.tree.map(np.asarray, state0.params),
             jax.tree.map(np.asarray, state0.batch_stats))

    def jax_run(params):
        # train_step donates its state: each run starts from a copy
        state = jax.tree.map(jnp.copy, state0).replace(
            params=jax.tree.map(jnp.asarray, params))
        state, logs = jstate.train_step(
            state, tuple(map(jnp.asarray, batch)), jax.random.key(0))
        return logs, tcomp.compressor_params_from_flax(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))

    jlogs, jvars = jax_run(start[0])
    # JAX's own spread: its largest deviation from starts one ulp away
    runs = [jax_run(_one_ulp(start[0], seed))[1] for seed in range(2)]
    spread = {k: np.max([np.abs(r[k].numpy() - w.numpy()) for r in runs])
              for k, w in jvars.items()}

    ts = trun.build_state(tcfg, 1, 1, device="cpu")
    ts.model.load_state_dict(tcomp.compressor_params_from_flax(*start))
    noise = _jax_pair_noise(jax.random.split(jax.random.key(0), 4)[1],
                            ts.model.rate_estimator.side_z_dim,
                            tcfg.encoder.z_dim)
    ts, tlogs = tstate.train_step(ts, tuple(map(torch.from_numpy, batch)),
                                  noise=noise)
    grads = {k: p.grad.numpy() for k, p in ts.model.named_parameters()
             if p.grad is not None}
    return ({k: float(v) for k, v in jlogs.items()}, jvars,
            {k: float(v) for k, v in tlogs.items()}, ts.model.state_dict(),
            spread, grads)


def test_mnist_vic_step_logs_match_jax():
    jlogs, _, tlogs, _, _, _ = _one_step()
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-5), k


def test_mnist_vic_step_variables_match_jax():
    """Every parameter after the update, and the running statistics of
    the ResNet's and the decoder's BatchNorms, at rtol 1e-4 / atol 1e-5
    of the tensor's largest entry (of a running mean: of its channels'
    largest standard deviation, the scale of the values it averages).

    Adam's first update is lr x g / (|g| + eps), about lr x sign(g), so it
    turns a small gradient's roundoff into +-lr. The ResNet's fp32
    gradients in train mode at batch 8 are ill-conditioned (BatchNorm's
    backward cancels): against the same network in float64 (JAX's x64
    mode), JAX's fp32 gradients are off by up to 18% of a tensor's
    largest entry, the port's by up to 16%, in other tensors. So an entry
    may instead move by at most 2 lr, where the port's gradient is under
    20% of its tensor's largest, for at most 0.1% of all entries
    (measured: 8,442 of 11,364,809, gradients up to 8.4% of their
    tensor's largest)."""
    _, jvars, _, tvars, _, grads = _one_step()
    assert set(tvars) == set(jvars)
    assert any(k.startswith("p_ZlX.mapper.BasicBlock_6.BatchNorm_2.var")
               for k in tvars)
    assert any(k.startswith("distortion_estimator.q_YlZ.BatchNorm_0.var")
               for k in tvars)
    lr = tconfig.preset("mnist_vic").optimizer_feat.lr
    flipped, total = 0, 0
    for k, w in jvars.items():
        got, want = tvars[k].numpy(), w.numpy()
        diff = np.abs(got - want)
        # a running mean is held on the scale of its channel's spread
        scale = np.sqrt(jvars[k[:-4] + "var"].numpy().max()) \
            if k.endswith(".mean") else np.abs(want).max()
        off = diff > 1e-5 * scale + 1e-4 * np.abs(want)
        total += want.size
        if not off.any():
            continue
        assert k in grads, k    # running statistics: no update to flip
        g = np.abs(grads[k])
        assert np.all(diff[off] <= 2 * lr * (1 + 1e-3)), k
        assert np.all(g[off] <= 0.2 * g.max()), k
        flipped += int(off.sum())
    assert flipped <= total // 1000, (flipped, total)


# ---------------------------------------------------------------------------
# Pretrained encoders
# ---------------------------------------------------------------------------


def _model(seed):
    cfg = tconfig.apply_overrides(tconfig.preset("mnist_vic"), SMALL)
    trun.instantiate_datamodule(cfg, cfg.data_feat)
    return cfg, trun.build_state(
        dataclasses.replace(cfg, trainer=dataclasses.replace(
            cfg.trainer, seed=seed)), 1, device="cpu").model


def test_load_pretrained_encoder_from_a_save_weights_export(tmp_path):
    cfg, a = _model(1)
    _, b = _model(2)
    # move a's running statistics off their init
    a.p_ZlX(torch.rand(4, 32, 32, 1), training=True)
    tckpt.save_weights(tmp_path / "best_featurizer", a.state_dict())
    before = {k: v.clone() for k, v in b.state_dict().items()}
    tpre.load_pretrained_encoder(cfg.encoder, b,
                                 str(tmp_path / "best_featurizer"))
    sa, sb = a.state_dict(), b.state_dict()
    for k in sb:
        want = sa[k] if k.startswith("p_ZlX.mapper.") else before[k]
        assert torch.equal(sb[k], want), k
    assert any(not torch.equal(sa[k], before[k]) for k in sb
               if k.startswith("p_ZlX.mapper.") and k.endswith(".mean"))


def test_load_pretrained_encoder_from_a_flat_npz(tmp_path):
    """A JAX ResNet's tree flattened with '/', parameters under `params/`
    and statistics under `batch_stats/`: the port's tower becomes JAX's."""
    from lossyless_tpu.nn import resnet as jresnet

    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 1)).astype(
        np.float32)
    jm = jresnet.ResNet(out_dim=16, in_shape=(32, 32, 1))
    v = jm.init(jax.random.key(3), jnp.asarray(x))
    _, new = jm.apply(v, jnp.asarray(x), training=True,
                      mutable=["batch_stats"])
    flat = {}
    for col, tree in (("params", v["params"]),
                      ("batch_stats", new["batch_stats"])):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([col] + [p.key for p in path])] = np.asarray(leaf)
    np.savez(tmp_path / "tower.npz", **flat)
    cfg, model = _model(1)
    tpre.load_pretrained_encoder(cfg.encoder, model,
                                 str(tmp_path / "tower.npz"))
    want = tlayers.params_from_flax(tcomp._merge_stats(
        jax.tree.map(np.asarray, v["params"]),
        jax.tree.map(np.asarray, new["batch_stats"])))
    sd = model.state_dict()
    for k, w in want.items():
        assert torch.equal(sd["p_ZlX.mapper." + k], w), k
    want_out = np.asarray(jm.apply({"params": v["params"],
                                    "batch_stats": new["batch_stats"]},
                                   jnp.asarray(x)))
    got = model.p_ZlX.mapper(torch.from_numpy(x)).detach().numpy()
    _close(got, want_out)


def test_load_pretrained_encoder_refusals(tmp_path):
    cfg, model = _model(1)
    with pytest.raises(FileNotFoundError):
        tpre.load_pretrained_encoder(cfg.encoder, model,
                                     str(tmp_path / "absent"))
    # a torch file in no layout the converters read: the converter's
    # error, naming the arch and the supported converters
    torch.save({"conv1.weight": torch.zeros(1)}, tmp_path / "rn.pt")
    with pytest.raises(ValueError, match="converter for encoder.arch="
                                         "'resnet'.*supported"):
        tpre.load_pretrained_encoder(cfg.encoder, model,
                                     str(tmp_path / "rn.pt"))
    # JAX's orbax export directories are a kept difference: refused,
    # naming the formats this package reads
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="directory.*save_weights"
                                                  " export.*torch.*npz"):
        tpre.load_pretrained_encoder(cfg.encoder, model,
                                     str(tmp_path / "orbax"))
    np.savez(tmp_path / "bad.npz", **{"params/Conv_0/kernel":
                                      np.zeros((3, 3, 2, 64), np.float32)})
    with pytest.raises(ValueError, match="do not fit"):
        tpre.load_pretrained_encoder(cfg.encoder, model,
                                     str(tmp_path / "bad.npz"))


# ---------------------------------------------------------------------------
# main on the six presets, and the experiment CLI
# ---------------------------------------------------------------------------

TINY = ["encoder.z_dim=16", "distortion.arch_kwargs.hid_dim=8",
        "online.arch_kwargs.hid_dim=16", "data_feat.kwargs.synthetic=True",
        "data_feat.kwargs.synthetic_n=96", "data_feat.batch_size=16",
        "data_feat.val_batch_size=32", "data_feat.n_epochs=2",
        "predictor.n_epochs=1", "predictor.batch_size=16",
        "predictor.arch_kwargs.hid_dim=32", "trainer.log_every=2",
        "rate.eb_use_pallas=True"]
STAGES = ("featurizer", "communication", "predictor")


def _tiny(name, root, extra=()):
    return tconfig.apply_overrides(tconfig.preset(name), TINY + list(extra) + [
        f"out_dir={root}/out", f"ckpt_dir={root}/ckpt"])


def _csv_keys(stage_dir, stage):
    with (Path(stage_dir) / f"results_{stage}.csv").open() as f:
        return next(csv.reader(f))


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """JAX's results-CSV keys of `mnist_vic` at the tiny size."""
    root = tmp_path_factory.mktemp("jax")
    cfg = jconfig.apply_overrides(jconfig.preset("mnist_vic"), TINY + [
        f"out_dir={root}/out", f"ckpt_dir={root}/ckpt"])
    jrun.main(cfg)
    return {s: _csv_keys(cfg.stage_dir, s) for s in STAGES}


@pytest.mark.parametrize("name", [n for n in PRESETS if "stag" not in n])
def test_main_writes_jaxs_results(name, jax_keys, tmp_path):
    seen = []

    def spy(cfg, *a, **k):
        out = real(cfg, *a, **k)
        seen.append(out[0].model.cfg.rate.warmup_steps)
        return out

    real = trun.run_featurizer_stage
    trun.run_featurizer_stage = spy
    try:
        # augmnist_aug's probe reads MNIST (data_pred): synthetic here too
        extra = ["data_pred.kwargs.synthetic=True",
                 "data_pred.kwargs.synthetic_n=96"] \
            if name.startswith("augmnist_aug") else []
        cfg = _tiny(name, tmp_path, extra)
        metrics = trun.main(cfg, device="cpu")
    finally:
        trun.run_featurizer_stage = real
    for stage in STAGES:
        assert (Path(cfg.stage_dir) / f"{stage}_end.txt").exists()
        assert _csv_keys(cfg.stage_dir, stage) == jax_keys[stage], stage
    assert math.isfinite(metrics["test/pred/acc"])
    assert metrics["test/comm/n_bits"] > 0
    # augmnist_aug_warm: 5 epochs of 5 steps with a detached rate
    assert seen == [25 if name.endswith("_warm") else 0]


def test_staggered_presets_chain_through_the_export(tmp_path):
    """Step 1 trains the encoder (lossless rate, featurizer only); step 2
    reads its export through `encoder.pretrained_path`, keeps the encoder
    frozen and trains the hyperprior rate on it."""
    s1 = _tiny("mnist_stag_step1", tmp_path)
    m1 = trun.main(s1, device="cpu")
    assert math.isfinite(m1["test/feat/loss"])
    assert not (Path(s1.stage_dir) / "predictor_end.txt").exists()
    export = Path(s1.ckpt_dir) / s1.long_name / "best_featurizer"
    s2 = _tiny("mnist_stag_step2", tmp_path,
               [f"encoder.pretrained_path={export}"])
    assert s2.long_name != s1.long_name
    m2 = trun.main(s2, device="cpu")
    assert math.isfinite(m2["test/pred/acc"]) and m2["test/comm/n_bits"] > 0
    w1 = tckpt.load_weights(export)
    w2 = tckpt.load_weights(Path(s2.ckpt_dir) / s2.long_name /
                            "best_featurizer")
    enc = [k for k in w2 if k.startswith("p_ZlX.mapper.")
           and not k.endswith((".mean", ".var"))]
    assert enc and all(torch.equal(w1[k], w2[k]) for k in enc)


def test_experiment_cli_runs_an_mnist_preset(tmp_path, capsys):
    out = tcli.main(["mnist_vic", "--dev", "--device", "cpu", *TINY,
                     f"out_dir={tmp_path}/out", f"ckpt_dir={tmp_path}/ckpt"])
    assert math.isfinite(out["test/pred/acc"])
    assert (tmp_path / "out" / "exp_augmnist_viz_VIC").exists()


def test_augmnist_aug_probe_trains_on_augmented_mnist(tmp_path):
    """`augmnist_aug`'s probe on `data_pred` (MNIST): run on the fly, its
    training batches are augmented by the ported warp, fresh each epoch
    (JAX's `_predictor_datasets`: `is_augment` follows
    `predictor.is_on_the_fly`). JAX's test split inherits that
    `is_augment` too, and the port keeps it (ROADMAP queue 3 item 10)."""
    cfg = _tiny("augmnist_aug", tmp_path, [
        "data_pred.kwargs.synthetic=True", "data_pred.kwargs.synthetic_n=96",
        "predictor.is_on_the_fly=True"])
    trun.instantiate_datamodule(cfg, cfg.data_feat)
    pred_train, pred_val, _ = trun._predictor_datasets(cfg, None, None)
    assert pred_train.is_augment and pred_val.is_augment
    assert pred_train.augmenter() == taug.make_augmenter(
        timages.SPECS["mnist"].default_equivalence)
    seen = []
    real = type(pred_train).batches

    def spy(ds, *a, **k):
        for b in real(ds, *a, **k):
            seen.append(ds.is_augment)
            yield b

    type(pred_train).batches = spy
    try:
        metrics = trun.main(cfg, device="cpu")
    finally:
        type(pred_train).batches = real
    assert math.isfinite(metrics["test/pred/acc"])
    assert True in seen     # the probe's on-the-fly batches, augmented
