"""The STL10 experiments of the port against the JAX package.

* one training step of a tiny `stl10_bince` (the contrastive distortion
  on ResNet-18 at 96 px, two views, the factorized rate) and of a tiny
  `stl10_balle` (BALLE with the spatial hyperprior, relu and GDN), from
  JAX's weights on the same batch and draws: logs rtol 1e-4 / atol 1e-5,
  the updated variables as tests/test_torch_mnist_path.py holds deep fp32
  nets (rtol 1e-4 / atol 1e-5 of the largest entry, an Adam step may go
  another way on at most 0.1% of the entries where the gradient is under
  20% of its module's largest; ROADMAP queue 3 item 9);
* `main` of each of the six STL10 presets at a tiny size on the CPU,
  writing JAX's results-CSV keys (JAX's keys from its own `main` of the
  same preset with small MLPs for its networks: the keys follow the rate
  and the distortion, not the networks), the probe's datasets (unlabeled
  featurizer, labeled probe, unaugmented unless on the fly), and the
  experiment CLI on one STL10 preset.
"""

import csv
import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import state as tstate

PRESETS = ["stl10_bince", "stl10_balle", "stl10_rate_variation",
           "stl10_dist_variation", "stl10_action_dist_shift",
           "stl10_understand_VIC"]
B = 4

# ---------------------------------------------------------------------------
# One training step of the whole compressor
# ---------------------------------------------------------------------------

STEP_SMALL = {
    "stl10_bince": ["encoder.z_dim=16", "distortion.project_dim=8",
                    "online.arch_kwargs.hid_dim=16"],
    "stl10_balle": ["encoder.z_dim=256", "rate.n_channels=4",
                    "encoder.arch_kwargs.hid_dim=8",
                    "distortion.arch_kwargs.hid_dim=8"],
}
COMMON = ["trainer.precision=fp32", "data_feat.kwargs.synthetic=True",
          "data_feat.kwargs.synthetic_n=40"]
GDN = ["encoder.arch_kwargs.activation=gdn",
       "distortion.arch_kwargs.activation=gdn"]


def _uniform(key, shape) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.uniform(
        key, shape, jnp.float32, -0.5, 0.5)))


def _draws(model, cfg) -> dict:
    """The rate noise JAX's train_step draws with `jax.random.key(0)`
    (`compressor.py`: the anchor's from split(key, 4)[1], the positive's
    from [3]; the spatial hyperprior's inner pair over the folded rows)."""
    keys = jax.random.split(jax.random.key(0), 4)
    rate = model.rate_estimator
    if isinstance(rate, trates.HRateHyperpriorSpatial):
        r1, r2 = jax.random.split(keys[1])
        rows = B * rate.side_dim ** 2
        return {"noise": (_uniform(r1, (rows, rate.inner.side_z_dim)),
                          _uniform(r2, (rows, rate.n_channels)))}
    z = cfg.encoder.z_dim
    return {"noise": (_uniform(keys[1], (B, z)), _uniform(keys[3], (B, z)))}


@functools.lru_cache(maxsize=None)
def one_step(name: str, extra: tuple = ()):
    """JAX's and the port's logs, variables and gradients after one step
    of `name` at small widths from JAX's initial weights."""
    ov = STEP_SMALL[name] + COMMON + list(extra)
    jcfg = jconfig.apply_overrides(jconfig.preset(name), ov)
    tcfg = tconfig.apply_overrides(tconfig.preset(name), ov)
    ds = trun.instantiate_datamodule(tcfg, tcfg.data_feat)
    jcfg.in_shape, jcfg.target_shape, jcfg.aux_shape = \
        tcfg.in_shape, tcfg.target_shape, tcfg.aux_shape
    batch = tuple(t.numpy() for t in next(ds.batches(B, seed=0)))
    model = JLC(jcfg.compressor_config())
    opts = [jstate.bind_schedule_steps(o, 1, 1)
            for o in (jcfg.optimizer_feat, jcfg.optimizer_online,
                      jcfg.optimizer_coder)]
    state = jstate.TrainState.create(
        model, tuple(map(jnp.asarray, batch)), jax.random.key(1),
        main=opts[0], online=opts[1], coder=opts[2])
    start = (jax.tree.map(np.asarray, state.params),
             jax.tree.map(np.asarray, state.batch_stats))
    state, jlogs = jstate.train_step(state, tuple(map(jnp.asarray, batch)),
                                     jax.random.key(0))
    jvars = tcomp.compressor_params_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats))

    ts = trun.build_state(tcfg, 1, 1, device="cpu")
    ts.model.load_state_dict(tcomp.compressor_params_from_flax(*start))
    ts, tlogs = tstate.train_step(ts, tuple(map(torch.from_numpy, batch)),
                                  **_draws(ts.model, tcfg))
    grads = {k: p.grad.numpy() for k, p in ts.model.named_parameters()
             if p.grad is not None}
    lr = tcfg.optimizer_feat.lr
    return ({k: float(v) for k, v in jlogs.items()}, jvars,
            {k: float(v) for k, v in tlogs.items()}, ts.model.state_dict(),
            grads, lr)


def check_variables(jvars, tvars, grads, lr):
    """Every parameter and running statistic after the update at rtol
    1e-4 / atol 1e-5 of the tensor's largest entry (a running mean: of
    its channels' largest standard deviation); an entry may instead move
    by at most 2 lr (Adam's first update, lr x g / (|g| + eps), the other
    way or by another fraction of lr) where its gradient is under 20% of
    the largest gradient of its module's tensors (the scale of the terms
    it sums), for at most 0.1% of all entries. Measured: the spatial
    rate's `inner.affine.biasing` gradient sums d rate / d z over 256
    rows that cancel to 2e-6..2e-5 (JAX ~5e-7) beside its sibling
    `scaling`'s 1.2, so Adam moves it by 0.98-0.996 lr in either run."""
    assert set(tvars) == set(jvars)

    def module_scale(k):
        parent = k.rsplit(".", 1)[0]
        return max(np.abs(g).max() for j, g in grads.items()
                   if j.rsplit(".", 1)[0] == parent)

    flipped, total = 0, 0
    for k, w in jvars.items():
        got, want = tvars[k].numpy(), w.numpy()
        diff = np.abs(got - want)
        scale = np.sqrt(jvars[k[:-4] + "var"].numpy().max()) \
            if k.endswith(".mean") else np.abs(want).max()
        off = diff > 1e-5 * scale + 1e-4 * np.abs(want)
        total += want.size
        if not off.any():
            continue
        assert k in grads, k    # running statistics: no update to flip
        g = np.abs(grads[k])
        assert np.all(diff[off] <= 2 * lr * (1 + 1e-3)), k
        assert np.all(g[off] <= 0.2 * module_scale(k)), k
        flipped += int(off.sum())
    assert flipped <= total // 1000, (flipped, total)


CASES = [("stl10_bince", ()), ("stl10_balle", ()), ("stl10_balle", GDN)]
IDS = ["bince", "balle", "balle-gdn"]


@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_stl10_step_logs_match_jax(name, extra):
    jlogs, _, tlogs, _, _, _ = one_step(name, tuple(extra))
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-5), k


@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_stl10_step_variables_match_jax(name, extra):
    _, jvars, _, tvars, grads, lr = one_step(name, tuple(extra))
    if name == "stl10_bince":
        assert "distortion_estimator.projector.Dense_0.kernel" in tvars
        assert "p_ZlX.mapper.BasicBlock_7.BatchNorm_1.var" in tvars
    else:
        assert "rate_estimator.inner.side_encoder.Dense_0.kernel" in tvars
        assert "distortion_estimator.q_YlZ.ConvTranspose_3.kernel" in tvars
        if extra:
            assert "p_ZlX.mapper.GDN_2.gamma_sqrt" in tvars
    check_variables(jvars, tvars, grads, lr)


# ---------------------------------------------------------------------------
# main on the six presets, the probe's datasets, the experiment CLI
# ---------------------------------------------------------------------------

TINY = ["encoder.z_dim=16", "online.arch_kwargs.hid_dim=16",
        "data_feat.kwargs.synthetic=True", "data_feat.kwargs.synthetic_n=16",
        "data_feat.batch_size=8", "data_feat.val_batch_size=16",
        "data_feat.n_epochs=1", "predictor.n_epochs=1",
        "predictor.batch_size=8", "predictor.arch_kwargs.hid_dim=32",
        "trainer.log_every=1", "rate.eb_use_pallas=True"]
PER_PRESET = {
    "stl10_bince": ["distortion.project_dim=8"],
    "stl10_balle": ["encoder.z_dim=256", "rate.n_channels=4",
                    "encoder.arch_kwargs.hid_dim=8"],
}
PRED = ["distortion.arch_kwargs.hid_dim=8", "data_pred.kwargs.synthetic=True",
        "data_pred.kwargs.synthetic_n=16"]
# JAX's networks for its keys: small MLPs, which compile fastest
SMALL_NETS = ["encoder.arch=mlp", "encoder.arch_kwargs={'hid_dim': 8}",
              "distortion.arch=mlp", "distortion.arch_kwargs={'hid_dim': 8}"]
STAGES = ("featurizer", "communication", "predictor")
# the presets whose results-CSV keys differ: the others are
# stl10_understand_VIC's configuration under another name
KEYS_OF = {"stl10_bince": "stl10_bince", "stl10_balle": "stl10_balle",
           "stl10_rate_variation": "stl10_rate_variation",
           "stl10_dist_variation": "stl10_understand_VIC",
           "stl10_action_dist_shift": "stl10_understand_VIC",
           "stl10_understand_VIC": "stl10_understand_VIC"}


def _overrides(name) -> list:
    return TINY + PER_PRESET.get(name, []) + (
        PRED if name != "stl10_bince" else [])


def _csv_keys(stage_dir, stage):
    with (Path(stage_dir) / f"results_{stage}.csv").open() as f:
        return next(csv.reader(f))


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """JAX's results-CSV keys of each distinct STL10 configuration at the
    tiny size, its networks swapped for small MLPs."""
    keys = {}
    for name in sorted(set(KEYS_OF.values())):
        root = tmp_path_factory.mktemp(name)
        cfg = jconfig.apply_overrides(jconfig.preset(name), _overrides(
            name) + SMALL_NETS + [f"out_dir={root}/out",
                                  f"ckpt_dir={root}/ckpt"])
        jrun.main(cfg)
        keys[name] = {s: _csv_keys(cfg.stage_dir, s) for s in STAGES}
    return keys


def _tiny(name, root, extra=()):
    return tconfig.apply_overrides(tconfig.preset(name), _overrides(name) + [
        *extra, f"out_dir={root}/out", f"ckpt_dir={root}/ckpt"])


@pytest.mark.parametrize("name", PRESETS)
def test_main_writes_jaxs_results(name, jax_keys, tmp_path):
    cfg = _tiny(name, tmp_path)
    metrics = trun.main(cfg, device="cpu")
    for stage in STAGES:
        assert (Path(cfg.stage_dir) / f"{stage}_end.txt").exists()
        assert _csv_keys(cfg.stage_dir, stage) == \
            jax_keys[KEYS_OF[name]][stage], stage
    for k in ("test/feat/loss", "test/comm/n_bits", "test/pred/loss",
              "test/pred/acc"):
        assert math.isfinite(metrics[k]), k
    assert metrics["test/comm/n_bits"] > 0


def test_balle_communication_decodes_the_dequantized_latent(tmp_path):
    """`stl10_balle`'s communication stage codes through
    `SpatialHyperpriorCoder`: its decode equals the eval-mode forward's
    z_hat to 1e-5 on the test split's first batch."""
    cfg = _tiny("stl10_balle", tmp_path, ["is_only_feat=True"])
    trun.main(cfg, device="cpu")
    cfg = tconfig.apply_precision(cfg)
    trun.instantiate_datamodule(cfg, cfg.data_feat)
    state = trun.build_state(cfg, 0, device="cpu")
    state.model.load_state_dict(trun.load_weights(
        Path(cfg.ckpt_dir) / cfg.long_name / "best_featurizer"))
    coder = trates.SpatialHyperpriorCoder(state.model.rate_estimator)
    test = trun._test_dataset(cfg, cfg.data_pred)
    x, _, _ = next(test.batches(8, seed=0))
    with torch.no_grad():
        z = state.model.encode(x)
        z_hat = state.model.features(x)
    streams = coder.compress(z.numpy())
    assert len(streams[0]) == 8 * 64
    np.testing.assert_allclose(coder.decompress(streams), z_hat.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("on_the_fly", [False, True])
def test_probe_datasets_unlabeled_featurizer_labeled_probe(on_the_fly,
                                                           tmp_path):
    """`stl10_understand_VIC`: the featurizer's split is STL10's unlabeled
    one (targets -1, augmented), the probe's is labeled STL10, augmented
    only on the fly (JAX's `_predictor_datasets`; queue 3 item 10: the
    test split follows it)."""
    cfg = _tiny("stl10_understand_VIC", tmp_path,
                [f"predictor.is_on_the_fly={on_the_fly}"])
    feat = trun.instantiate_datamodule(cfg, cfg.data_feat)
    assert feat.train_split == "unlabeled" and (feat.targets == -1).all()
    assert feat.augmenter() is not None
    pred_train, pred_val, target_shape = trun._predictor_datasets(
        cfg, feat, None)
    assert target_shape == 10 and pred_train.train_split is None
    assert (pred_train.targets >= 0).all() and (pred_val.targets >= 0).all()
    assert pred_train.is_augment == on_the_fly == pred_val.is_augment
    assert timages.ImageDataset(name="stl10", synthetic=True,
                                synthetic_n=24).is_augment


def test_experiment_cli_runs_an_stl10_preset(tmp_path):
    out = tcli.main(["stl10_balle", "--dev", "--device", "cpu",
                     *_overrides("stl10_balle"),
                     f"out_dir={tmp_path}/out", f"ckpt_dir={tmp_path}/ckpt"])
    assert math.isfinite(out["test/pred/acc"])
    assert math.isfinite(out["test/comm/n_bits"])
    assert (tmp_path / "out" / "exp_stl10_balle").exists()
