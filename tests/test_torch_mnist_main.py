"""`main` of the six augmented-MNIST presets and the experiment CLI,
against the JAX package.

* a short `main` of each preset at a tiny size on the CPU (the staggered
  pair chained through `encoder.pretrained_path`), writing JAX's
  results-CSV keys (JAX's from its own `main` of `mnist_vic` with small
  MLPs for its networks, in fp32: the keys follow the rate and the
  distortion, not the networks or the precision);
* the experiment CLI on `mnist_vic`;
* `augmnist_aug`'s probe on augmented MNIST when it runs on the fly.
The one-step and network checks are in `tests/test_torch_mnist_path.py`.
"""

import csv
import math
from pathlib import Path

import pytest
import torch

from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.data import augmentations as taug
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import checkpoints as tckpt
from tests import torch_threads  # noqa: F401  (one pool a worker)

PRESETS = ["mnist_vic", "augmnist_RD", "augmnist_aug", "augmnist_aug_warm",
           "mnist_stag_step1", "mnist_stag_step2"]

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
# JAX's networks for its keys: small MLPs, which compile fastest
SMALL_NETS = ["encoder.arch=mlp", "encoder.arch_kwargs={'hid_dim': 8}",
              "distortion.arch=mlp", "distortion.arch_kwargs={'hid_dim': 8}"]


def _tiny(name, root, extra=()):
    return tconfig.apply_overrides(tconfig.preset(name), TINY + list(extra) + [
        f"out_dir={root}/out", f"ckpt_dir={root}/ckpt"])


def _csv_keys(stage_dir, stage):
    with (Path(stage_dir) / f"results_{stage}.csv").open() as f:
        return next(csv.reader(f))


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """JAX's results-CSV keys of `mnist_vic` at the tiny size, its
    networks swapped for small MLPs, in fp32."""
    root = tmp_path_factory.mktemp("jax")
    cfg = jconfig.apply_overrides(jconfig.preset("mnist_vic"), TINY + [
        *SMALL_NETS, "trainer.precision=fp32", f"out_dir={root}/out",
        f"ckpt_dir={root}/ckpt"])
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
