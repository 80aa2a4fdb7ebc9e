"""`main` of the six STL10 presets, the probe's datasets and the
experiment CLI, against the JAX package.

* `main` of each of the six STL10 presets at a tiny size on the CPU,
  writing JAX's results-CSV keys (JAX's keys from its own `main` of the
  same preset with small MLPs for its networks: the keys follow the rate
  and the distortion, not the networks);
* `stl10_balle`'s communication stage decoding the dequantized latent;
* the probe's datasets (unlabeled featurizer, labeled probe, unaugmented
  unless on the fly), and the experiment CLI on one STL10 preset.
The one-step checks are in `tests/test_torch_stl10_path.py`.
"""

import csv
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from tests import torch_threads  # noqa: F401  (one pool a worker)

PRESETS = ["stl10_bince", "stl10_balle", "stl10_rate_variation",
           "stl10_dist_variation", "stl10_action_dist_shift",
           "stl10_understand_VIC"]

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
