"""`galaxy_regression` of the port against the JAX package.

* one featurizer step at a tiny width (32 px synthetic galaxies, BALLE at
  hid_dim 8, z = 256 over 16 channels, the regression online probe) from
  JAX's initial weights on the same batch and rate noise: logs rtol 1e-4
  / atol 1e-5, the updated variables under
  tests/test_torch_stl10_path.py's `check_variables` rules;
* the regression predictor's `evaluate` on the same predictions: `loss`
  and `tasks_*` within 1e-5 of JAX's;
* the kaggle submission's CSV text equal to JAX's from the same
  predictions, and `run_predictor`'s three id cases: the split's ids,
  positional ids flagged `synthetic_positional` (from the port's tiny
  `main`), `skipped_no_ids`.
"""

import csv
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.analysis import kaggle as jkaggle
from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import predictor as jpred
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.analysis import kaggle as tkaggle
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.data import external as text
from lossyless_tpu_torch.data import ingest as tingest
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import predictor as tpred
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import state as tstate
from tests.test_torch_stl10_path import B, _draws, check_variables

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMALL = ["encoder.z_dim=256", "rate.n_channels=16",
         "encoder.arch_kwargs.hid_dim=8", "distortion.arch_kwargs.hid_dim=8",
         "online.arch_kwargs.hid_dim=16", "trainer.precision=fp32",
         "data_feat.kwargs.synthetic=True", "data_feat.kwargs.synthetic_n=12",
         "data_feat.kwargs.resolution=32"]


@pytest.fixture(scope="module")
def one_step():
    """JAX's and the port's logs, variables and gradients after one step
    of the tiny galaxy_regression from JAX's initial weights."""
    jcfg = jconfig.apply_overrides(jconfig.preset("galaxy_regression"),
                                   SMALL)
    tcfg = tconfig.apply_overrides(tconfig.preset("galaxy_regression"),
                                   SMALL)
    ds = trun.instantiate_datamodule(tcfg, tcfg.data_feat, device="cpu")
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
    return (tcfg, {k: float(v) for k, v in jlogs.items()}, jvars,
            {k: float(v) for k, v in tlogs.items()}, ts.model.state_dict(),
            grads, tcfg.optimizer_feat.lr)


def test_galaxy_step_logs_match_jax(one_step):
    cfg, jlogs, _, tlogs, _, _, _ = one_step
    assert cfg.aux_shape == (32, 32, 3) and cfg.target_shape == 37
    assert set(tlogs) == set(jlogs) and "online_loss" in tlogs
    for k in jlogs:
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-5), k


def test_galaxy_step_variables_match_jax(one_step):
    _, _, jvars, _, tvars, grads, lr = one_step
    assert "rate_estimator.inner.side_encoder.Dense_0.kernel" in tvars
    assert "distortion_estimator.q_YlZ.ConvTranspose_3.kernel" in tvars
    check_variables(jvars, tvars, grads, lr)


def test_regression_evaluate_matches_jax():
    rng = np.random.default_rng(4)
    preds = rng.normal(0.1, 0.2, (30, 37)).astype(np.float32)
    y = rng.dirichlet(np.ones(37), 30).astype(np.float32)
    jcfg = jpred.PredictorConfig(arch="identity", arch_kwargs={},
                                 is_classification=False)
    jt = jpred.PredictorTrainer(jcfg, 37, 37)
    jt.model, jt.variables = jpred.Predictor(jcfg, 37, 37), {}
    tt = tpred.PredictorTrainer(tpred.PredictorConfig(
        arch="identity", arch_kwargs={}, is_classification=False), 37, 37,
        device="cpu")
    tt.model = tt._build(0)
    j, t = jt.evaluate(preds, y), tt.evaluate(preds, y)
    assert set(t) == set(j) and "acc" not in t
    for k in ("loss", "tasks_max", "tasks_std", "tasks_min", "tasks_mean",
              "tasks_median"):
        assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-7), k


def test_kaggle_csv_text_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    preds = rng.normal(0.5, 0.6, (9, 37))      # clipped to [0, 1]
    ids = rng.choice(np.arange(100000, 1000000), 9, replace=False)
    t = tkaggle.write_kaggle_submission(ids, preds, tmp_path / "t" / "s.csv")
    j = jkaggle.write_kaggle_submission(ids, preds, tmp_path / "j.csv")
    assert t.read_text() == j.read_text()
    assert tkaggle.GALAXY_COLUMNS == jkaggle.GALAXY_COLUMNS
    with pytest.raises(ValueError, match="expected 37 columns"):
        tkaggle.write_kaggle_submission(ids, preds[:, :5], tmp_path / "x")


def test_submission_ids_of_the_split(tmp_path):
    """The ingested test split's GalaxyIDs in its order; a split without
    ids writes nothing and says so."""
    raw = chip_smoke.write_kaggle_tree(tmp_path / "raw", 4, 6, side=64)
    root = tingest.ingest_kaggle_galaxy(raw, tmp_path / "data",
                                        resolution=16, crop=48)
    cfg = tconfig.apply_overrides(tconfig.preset("galaxy_regression"),
                                  [f"out_dir={tmp_path}/out"])
    test = text.GalaxyZooDataset(split="test", data_dir=tmp_path / "data")
    preds = np.random.default_rng(0).uniform(size=(6, 37))
    out = trun._kaggle_submission(cfg, preds, test)
    assert set(out) == {"kaggle_submission"}
    with open(out["kaggle_submission"]) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 7
    np.testing.assert_array_equal([int(r[0]) for r in rows[1:]],
                                  np.load(root / "test_ids.npy"))
    train = text.GalaxyZooDataset(data_dir=tmp_path / "data")
    assert trun._kaggle_submission(cfg, preds, train) == \
        {"kaggle_submission": "skipped_no_ids"}


def test_tiny_main_writes_a_flagged_positional_submission(tmp_path):
    cfg = tconfig.apply_overrides(tconfig.preset("galaxy_regression"), [
        *SMALL, "data_feat.kwargs.synthetic_n=16",
        "data_pred.kwargs.synthetic=True", "data_pred.kwargs.synthetic_n=10",
        "data_pred.kwargs.resolution=32", "data_feat.batch_size=8",
        "data_feat.val_batch_size=8", "data_pred.batch_size=4",
        "data_feat.n_epochs=1", "predictor.n_epochs=1",
        "predictor.batch_size=4", "predictor.arch_kwargs.hid_dim=16",
        "rate.eb_use_pallas=True", f"out_dir={tmp_path}/out",
        f"ckpt_dir={tmp_path}/ckpt"])
    metrics = trun.main(cfg, device="cpu")
    assert metrics["kaggle_submission_ids"] == "synthetic_positional"
    with open(metrics["kaggle_submission"]) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["GalaxyID"] + tkaggle.GALAXY_COLUMNS
    assert [int(r[0]) for r in rows[1:]] == list(range(1, 11))
    values = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]])
    assert values.shape == (10, 37) and (values >= 0).all() and \
        (values <= 1).all()
    for k in ("test/feat/loss", "test/comm/n_bits", "test/pred/loss",
              "test/pred/tasks_mean"):
        assert math.isfinite(metrics[k]), k
    assert "test/pred/acc" not in metrics
    for stage in ("featurizer", "communication", "predictor"):
        assert (Path(cfg.stage_dir) / f"{stage}_end.txt").exists()
