"""The three-stage pipeline on the CLIP presets against the JAX package.

Held part by part, each on the same inputs and the same weights:

* the synthetic STL10 source (byte-equal) and `ImageDataset` batches (the
  same order, the ragged tail);
* `CheckpointManager`: last / best / NaN, resume, the `.tmp` / `.old`
  windows (JAX's `tests/test_resume.py` cases, reimplemented);
* the plateau controller (the same scale steps) and its scale in the lr;
* `Lossless` / `lossless_bits` (equal), the online probe and a
  `clip_lossyZ` compressor's eval step (fp32, 1e-5), the predictor's
  `evaluate` (equal on the same logits) and its fit (1e-4 after 2 epochs
  from the same weights and permutation);
* the whole pipeline, `main(cfg)` on the CPU at a tiny tower for
  `clip_bottleneck_linear_eval` and `clip_raw_linear_eval`: the stage
  sentinels, the results CSVs with JAX's keys (not its values: the two
  SGD paths sum in other orders), stage skipping on a second call, and a
  featurizer stage that resumes from its `last` checkpoint.
"""

import csv
import dataclasses
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors import compressor as jcomp
from lossyless_tpu.compressors import rates as jrates
from lossyless_tpu.data import images as jimages
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import predictor as jpred
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.data import augmentations as taug
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.data.balancing import PETS37_BALANCING_WEIGHTS
from lossyless_tpu_torch.data.features import FeaturesDataset
from lossyless_tpu_torch.nn.mlp import params_from_flax
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import predictor as tpred
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train import state as tstate


def _merge(params, stats=None) -> dict:
    """flax params (+ batch_stats) -> one nested tree."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in jax.tree.map(np.asarray, params).items()}
    for k, v in (stats or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) \
            else np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stl10", "cifar10"])
@pytest.mark.parametrize("split", ["train", "test", "unlabeled"])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_images_are_jaxs_bytes(name, split, seed):
    jx, jy = jimages._synthetic(jimages.SPECS[name], split, 37, seed)
    tx, ty = timages._synthetic(timages.SPECS[name], split, 37, seed)
    assert tx.dtype == jx.dtype and tx.tobytes() == jx.tobytes()
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("split", ["train", "validation", "test"])
@pytest.mark.parametrize("at,norm", [("target", False),
                                     ("representative", True),
                                     ("equiv_x", True)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_image_batches_match_jax(split, at, norm, drop_last):
    kw = dict(name="stl10", split=split, synthetic=True, synthetic_n=100,
              is_augment=False, additional_target=at, is_normalize=norm,
              seed=2)
    jds, tds = jimages.ImageDataset(**kw), timages.ImageDataset(**kw)
    assert len(tds) == len(jds)
    jb = list(jds.batches(8, n_epochs=2, seed=3, drop_last=drop_last))
    tb = list(tds.batches(8, n_epochs=2, seed=3, drop_last=drop_last))
    assert len(tb) == len(jb) and len(tb[-1][0]) == len(jb[-1][0])
    for (jx, jy, ja), (tx, ty, ta) in zip(jb, tb):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=1e-7)


def test_augmentation_raises_and_names_the_queue(tmp_path):
    """STL10's augmentations are ported (its batches are augmented by the
    default chain), and so is the imagenet module: `get_datamodule`
    returns a `StreamingImageFolder`, or raises FileNotFoundError without
    its folder, as JAX's does."""
    from lossyless_tpu.data import external as jext
    from lossyless_tpu_torch.data import external as text

    ds = timages.ImageDataset(name="stl10", synthetic=True, synthetic_n=16)
    x, _, raw = next(ds.batches(4))
    assert x.shape == raw.shape == (4, 96, 96, 3)
    assert not torch.allclose(x, raw)
    assert ds.augmenter() == taug.make_augmenter(
        ("hflip", "resize_crop", "color", "gray"))
    for get in (timages.get_datamodule, jimages.get_datamodule):
        with pytest.raises(FileNotFoundError, match="imagenet"):
            get("imagenet", data_dir=tmp_path)
    (tmp_path / "imagenet" / "train" / "n01").mkdir(parents=True)
    folder = timages.get_datamodule("imagenet", data_dir=tmp_path)
    assert isinstance(folder, text.StreamingImageFolder) and len(folder) == 0
    assert folder.classes == jext.StreamingImageFolder(
        data_dir=tmp_path).classes == ["n01"]


def test_missing_files_raise_rather_than_synthesize(tmp_path):
    with pytest.raises(FileNotFoundError):
        timages.ImageDataset(name="stl10", split="test", data_dir=tmp_path)


def test_features_dataset_batches_and_npz(tmp_path):
    rng = np.random.default_rng(0)
    ds = FeaturesDataset(rng.normal(size=(11, 4)), rng.integers(0, 3, 11),
                         additional_target="input")
    from lossyless_tpu.data.features import FeaturesDataset as JFD

    jds = JFD(ds.features, ds.targets, additional_target="input")
    for a, b in zip(ds.batches(4, n_epochs=2, seed=1, drop_last=False),
                    jds.batches(4, n_epochs=2, seed=1, drop_last=False)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    ds.save(tmp_path / "f.npz")
    back = FeaturesDataset.load(tmp_path / "f.npz")
    np.testing.assert_array_equal(back.features, ds.features)
    np.testing.assert_array_equal(back.targets, ds.targets)


# ---------------------------------------------------------------------------
# Checkpoints and the plateau controller
# ---------------------------------------------------------------------------


class Toy(torch.nn.Module):
    """A one-parameter model with the compressor's `step` interface."""

    def __init__(self, value=1.0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((3,), value))

    def step(self, x, y, aux, *, training, step, generator=None,
             noise=None, eps=None):
        return (self.w * x).sum(), {}


def _toy_state(value=1.0, scheduler="none"):
    return tstate.TrainState.create(
        Toy(value), main=tstate.OptimConfig(mode="sgd", lr=0.1,
                                            scheduler=scheduler))


def _w(state):
    return state.model.w.detach().clone()


@pytest.fixture
def mgr(tmp_path):
    m = tckpt.CheckpointManager(tmp_path / "ckpt")
    m.save_last(_toy_state(3.0), step=3)
    return m


def test_last_best_and_nan(tmp_path):
    m = tckpt.CheckpointManager(tmp_path / "ckpt", mode="min")
    assert not m.has_last and m.restore(_toy_state(), "last") is None
    assert not m.maybe_save_best(_toy_state(), 1, float("nan"))
    assert m.best_value is None
    assert m.maybe_save_best(_toy_state(2.0), 1, 5.0)
    assert not m.maybe_save_best(_toy_state(3.0), 2, 6.0)
    assert not m.maybe_save_best(_toy_state(4.0), 3, float("nan"))
    assert m.maybe_save_best(_toy_state(5.0), 4, 4.0)
    assert m.best_value == 4.0
    got = m.restore(_toy_state(), "best")
    assert torch.equal(_w(got), torch.full((3,), 5.0))
    m.save_last(_toy_state(7.0), step=9)
    import json

    meta = json.loads((m.dir / "meta.json").read_text())
    assert meta == {"best_value": 4.0, "last_step": 9, "best_step": 4}
    mx = tckpt.CheckpointManager(tmp_path / "ckpt_max", mode="max")
    assert mx.maybe_save_best(_toy_state(), 1, 1.0)
    assert mx.maybe_save_best(_toy_state(), 2, 2.0)
    assert not mx.maybe_save_best(_toy_state(), 3, 1.5)


def test_resume_restores_model_optimizer_step_and_scale(tmp_path):
    state = _toy_state(scheduler="plateau")
    x = (torch.tensor([1.0, 2.0, 3.0]), None, None)
    for _ in range(2):
        tstate.train_step(state, x)
    tstate.set_plateau_scale(state, 0.25, "main")
    m = tckpt.CheckpointManager(tmp_path / "ckpt")
    m.save_last(state, state.step)
    fresh = _toy_state(scheduler="plateau")
    m.restore(fresh, "last")
    assert fresh.step == 2 and torch.equal(_w(fresh), _w(state))
    assert tstate.get_plateau_scale(fresh, "main") == 0.25
    # the momentum buffer came back: the next steps are the same
    tstate.train_step(state, x)
    tstate.train_step(fresh, x)
    assert torch.equal(_w(fresh), _w(state))


def test_mid_swap_window_resolves_to_tmp(mgr):
    last = mgr.dir / "last"
    shutil.copy(last, mgr.dir / "last.tmp")
    last.rename(mgr.dir / "last.old")
    assert mgr.has_last
    assert torch.equal(_w(mgr.restore(_toy_state())), torch.full((3,), 3.0))


def test_old_alone_resolves(mgr):
    (mgr.dir / "last").rename(mgr.dir / "last.old")
    assert mgr.has_last
    assert torch.equal(_w(mgr.restore(_toy_state())), torch.full((3,), 3.0))


def test_bare_tmp_is_not_a_checkpoint(tmp_path):
    m = tckpt.CheckpointManager(tmp_path / "ckpt")
    (m.dir / "last.tmp").write_bytes(b"partial")
    assert not m.has_last and m.restore(_toy_state()) is None


def test_mid_swap_window_is_healed(mgr):
    last = mgr.dir / "last"
    shutil.copy(last, mgr.dir / "last.tmp")
    last.rename(mgr.dir / "last.old")
    assert mgr.has_last  # first touch heals
    assert last.exists() and not (mgr.dir / "last.tmp").exists()
    assert not (mgr.dir / "last.old").exists()


def test_partial_tmp_with_old_falls_back_to_old(mgr):
    (mgr.dir / "last").rename(mgr.dir / "last.old")
    (mgr.dir / "last.tmp").write_bytes(b"partial")
    assert torch.equal(_w(mgr.restore(_toy_state())), torch.full((3,), 3.0))
    assert (mgr.dir / "last").exists()
    assert not (mgr.dir / "last.tmp").exists()


def test_save_heals_pending_window_first(mgr):
    last = mgr.dir / "last"
    shutil.copy(last, mgr.dir / "last.tmp")
    last.rename(mgr.dir / "last.old")
    mgr.save_last(_toy_state(9.0), step=4)
    assert torch.equal(_w(mgr.restore(_toy_state())), torch.full((3,), 9.0))


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_scale_steps_match_jax(mode):
    seq = [1.0, 0.9, 0.95, 0.95, 0.9, float("nan"), 0.8, 0.85, 0.85, 0.85,
           0.79, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]
    if mode == "max":
        seq = [-v for v in seq]
    kw = dict(factor=0.5, patience=2, threshold=1e-4, min_scale=0.1,
              mode=mode)
    j, t = jstate.ReduceLROnPlateau(**kw), tstate.ReduceLROnPlateau(**kw)
    got = [t.step(v) for v in seq]
    assert got == [j.step(v) for v in seq]
    assert len(set(got)) > 2   # the sequence reaches reductions


def test_plateau_scale_multiplies_the_lr():
    state = _toy_state(scheduler="plateau")
    assert state.lr_scales == {"main": 1.0}
    assert tstate._make_schedule(tstate.OptimConfig(
        scheduler="plateau", lr=0.1, total_steps=100))(50) == 0.1
    tstate.set_plateau_scale(state, 0.25, "main")
    x = torch.tensor([1.0, 2.0, 3.0])
    tstate.train_step(state, (x, None, None))
    # sgd's first step: w -= lr * scale * grad
    torch.testing.assert_close(_w(state), 1.0 - 0.025 * x)
    assert _toy_state().lr_scales == {}


# ---------------------------------------------------------------------------
# The modules: lossless rate, online probe, compressor, predictor
# ---------------------------------------------------------------------------


def test_lossless_rate_and_bits_match_jax():
    z = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32)
    jz, jr, jl = jrates.Lossless(16).apply({}, jnp.asarray(z), None,
                                          training=True)
    m = trates.make_rate_estimator(16, trates.RateConfig(mode="lossless"))
    tz, tr, tl = m(torch.from_numpy(z), None, training=True)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tl == dict(jl) == {}
    assert trates.lossless_bits(z) == jrates.lossless_bits(z)


@pytest.mark.parametrize("labels", ["some_unlabeled", "all_unlabeled",
                                    "regression"])
def test_online_evaluator_matches_jax(labels):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(9, 16)).astype(np.float32)
    cls = labels != "regression"
    if labels == "regression":
        y = rng.normal(size=(9, 5)).astype(np.float32)
    else:
        y = rng.integers(0, 5, 9)
        y[::3] = -1
        if labels == "all_unlabeled":
            y[:] = -1
    jcfg = jcomp.OnlineEvalConfig(arch_kwargs=dict(hid_dim=32),
                                  is_classification=cls)
    jm = jcomp.OnlineEvaluator(jcfg, 16, 5)
    params = jm.init(jax.random.key(0), jnp.asarray(z), jnp.asarray(y))
    jloss, jlogs = jm.apply(params, jnp.asarray(z), jnp.asarray(y))
    tm = tcomp.OnlineEvaluator(tcomp.OnlineEvalConfig(
        arch_kwargs=dict(hid_dim=32), is_classification=cls), 16, 5)
    tm.load_state_dict(params_from_flax(_merge(params["params"])))
    tz = torch.from_numpy(z).requires_grad_(True)
    tloss, tlogs = tm(tz, torch.from_numpy(y))
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(tlogs[k].detach()) == pytest.approx(
            float(jlogs[k]), rel=1e-5, abs=1e-6), k
    if labels == "all_unlabeled":
        assert float(tloss.detach()) == 0.0
    tloss.backward()
    assert tz.grad is None or not tz.grad.any()   # z is detached


TINY = ["encoder.arch_kwargs.width=64", "encoder.arch_kwargs.layers=2",
        "encoder.arch_kwargs.heads=2", "encoder.arch_kwargs.dtype=float32",
        "online.arch_kwargs.hid_dim=32"]


def test_clip_lossyz_eval_step_matches_jax():
    """A tiny clip_lossyZ compressor (hyperprior rate, the online probe)
    on JAX's weights: the eval step's logs to 1e-5."""
    jcfg = jconfig.apply_precision(jconfig.apply_overrides(
        jconfig.preset("clip_lossyZ"), TINY))
    tcfg = tconfig.apply_precision(tconfig.apply_overrides(
        tconfig.preset("clip_lossyZ"), TINY))
    for c in (jcfg, tcfg):
        c.in_shape, c.target_shape, c.aux_shape = (32, 32, 3), 10, 10
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(6, 32, 32, 3)).astype(np.float32)
    y = rng.integers(-1, 10, 6)
    batch = (x, y, y)
    jstate_ = jstate.TrainState.create(
        jcomp.LearnableCompressor(jcfg.compressor_config()),
        tuple(map(jnp.asarray, batch)), jax.random.key(0),
        main=jcfg.optimizer_feat)
    _, jlogs = jstate.eval_step(jstate_, tuple(map(jnp.asarray, batch)),
                                jax.random.key(1))
    tstate_ = trun.build_state(tcfg, 1, device="cpu")
    tstate_.model.load_state_dict(tcomp.compressor_params_from_flax(
        _merge(jstate_.params, jstate_.batch_stats)))
    _, tlogs = tstate.eval_step(tstate_, tuple(map(torch.from_numpy,
                                                   batch)))
    assert set(tlogs) == set(jlogs)
    assert {"online_loss", "online_acc", "online_err"} <= set(tlogs)
    for k in jlogs:
        assert float(tlogs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5,
                                                abs=1e-5), k


def test_predictor_evaluate_matches_jax_on_the_same_logits():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(40, 37)).astype(np.float32)
    y = rng.integers(0, 37, 40)
    jcfg = jpred.PredictorConfig(arch="identity", arch_kwargs={})
    jt = jpred.PredictorTrainer(jcfg, 37, 37)
    jt.model, jt.variables = jpred.Predictor(jcfg, 37, 37), {}
    tt = tpred.PredictorTrainer(tpred.PredictorConfig(
        arch="identity", arch_kwargs={}), 37, 37, device="cpu")
    tt.model = tt._build(0)
    for w in (None, PETS37_BALANCING_WEIGHTS):
        j = jt.evaluate(logits, y, balancing_weights=w)
        t = tt.evaluate(logits, y, balancing_weights=w)
        assert set(t) == set(j)
        for k in j:
            if k != "inference_time":
                assert t[k] == pytest.approx(j[k], rel=1e-6, abs=1e-7), k


class _FromJax(tpred.PredictorTrainer):
    """The port's trainer started from the JAX trainer's initial weights."""

    init_tree: dict = None

    def _build(self, seed):
        model = super()._build(seed)
        model.load_state_dict(params_from_flax(self.init_tree))
        return model


@pytest.mark.parametrize("arch,kw", [
    ("linear", {}),
    ("mlp", dict(hid_dim=32, n_hid_layers=2, norm_layer="batchnorm"))])
def test_probe_fit_matches_jax(arch, kw):
    rng = np.random.default_rng(3)
    z = rng.normal(size=(70, 12)).astype(np.float32)
    y = rng.integers(0, 4, 70)
    cfg = dict(arch=arch, arch_kwargs=kw, n_epochs=2, batch_size=16,
               lr=1e-2)
    jt = jpred.PredictorTrainer(jpred.PredictorConfig(**cfg), 12, 4)
    _, p0, bs0, _, _ = jt._init(z[:2], 5)
    jt.fit(z, y, seed=5)
    tt = _FromJax(tpred.PredictorConfig(**cfg), 12, 4, device="cpu")
    tt.init_tree = _merge(p0, bs0)
    tt.fit(z, y, seed=5)
    want = params_from_flax(_merge(jt.variables["params"],
                                   jt.variables.get("batch_stats")))
    got = tt.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
        assert not torch.equal(got[k], params_from_flax(tt.init_tree)[k]) \
            or k.endswith("bias"), k


def test_probe_fit_on_the_fly_matches_jax():
    """`fit_onfly`: the featurizer on every batch of every epoch (seed +
    epoch), ragged batches skipped, from the same weights."""
    kw = dict(name="stl10", split="test", synthetic=True, synthetic_n=40,
              is_augment=False, additional_target="target")
    jds, tds = jimages.ImageDataset(**kw), timages.ImageDataset(**kw)

    def feat(x):
        return x.reshape(x.shape[0], -1)[:, 1000:1012] * 4.0

    cfg = dict(arch="linear", arch_kwargs={}, n_epochs=2, batch_size=16,
               lr=1e-2)
    jt = jpred.PredictorTrainer(jpred.PredictorConfig(**cfg), 12, 10)
    x0 = next(jds.batches(16, n_epochs=1, seed=5))[0]
    _, p0, _, _, _ = jt._init(feat(jnp.asarray(x0[:2])), 5)
    jt.fit_onfly(jds, feat, seed=5)
    tt = _FromJax(tpred.PredictorConfig(**cfg), 12, 10, device="cpu")
    tt.init_tree = _merge(p0)
    tt.fit_onfly(tds, feat, seed=5)
    want = params_from_flax(_merge(jt.variables["params"]))
    for k, v in tt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The whole pipeline through main(cfg)
# ---------------------------------------------------------------------------

PIPE = TINY + ["data_feat.kwargs.synthetic=True",
               "data_feat.kwargs.synthetic_n=48",
               "data_feat.kwargs.is_augment=False",
               "data_feat.batch_size=16", "data_feat.val_batch_size=32",
               "predictor.n_epochs=2",
               "predictor.batch_size=16", "trainer.log_every=1",
               "rate.eb_use_pallas=True"]
STAGES = ("featurizer", "communication", "predictor")


def _cfgs(name, root):
    ov = PIPE + [f"out_dir={root}/out", f"ckpt_dir={root}/ckpt"]
    if not name.startswith("clip_raw"):   # the raw presets train nothing
        ov.append("data_feat.n_epochs=2")
    return (jconfig.apply_overrides(jconfig.preset(name), ov),
            tconfig.apply_overrides(tconfig.preset(name), ov))


def _csv_keys(stage_dir, stage):
    with (Path(stage_dir) / f"results_{stage}.csv").open() as f:
        return next(csv.reader(f))


@pytest.fixture(scope="module", params=["clip_bottleneck_linear_eval",
                                        "clip_raw_linear_eval"])
def pipeline_runs(request, tmp_path_factory):
    name = request.param
    jcfg, _ = _cfgs(name, tmp_path_factory.mktemp("jax"))
    jmetrics = jrun.main(jcfg)
    _, tcfg = _cfgs(name, tmp_path_factory.mktemp("port"))
    tmetrics = trun.main(tcfg, device="cpu")
    return name, jcfg, jmetrics, tcfg, tmetrics


def test_pipeline_writes_jaxs_results(pipeline_runs):
    name, jcfg, jm, tcfg, tm = pipeline_runs
    for stage in STAGES:
        assert (Path(tcfg.stage_dir) / f"{stage}_end.txt").exists(), stage
        assert _csv_keys(tcfg.stage_dir, stage) == \
            _csv_keys(jcfg.stage_dir, stage), stage
    assert set(tm) == set(jm)
    assert math.isfinite(tm["test/pred/acc"])
    assert (Path(tcfg.ckpt_dir) / tcfg.long_name / "best_featurizer") \
        .exists()
    if name == "clip_raw_linear_eval":   # no training: no checkpoints
        assert not (Path(tcfg.ckpt_dir) / tcfg.long_name / "feat" /
                    "last").exists()
        assert tm["test/comm/n_bits"] > 0


def test_second_main_skips_every_stage(pipeline_runs):
    _, _, _, tcfg, _ = pipeline_runs
    stamps = {p: p.stat().st_mtime_ns
              for p in Path(tcfg.stage_dir).iterdir()}
    trained = []
    real_step = tstate.train_step
    try:
        trun.train_step = lambda *a, **k: trained.append(1) or \
            real_step(*a, **k)
        assert trun.main(tcfg, device="cpu") == {}
    finally:
        trun.train_step = real_step
    assert trained == []
    assert {p: p.stat().st_mtime_ns
            for p in Path(tcfg.stage_dir).iterdir()} == stamps


def test_featurizer_stage_resumes_from_last(tmp_path, monkeypatch):
    """Killed after its first `save_last`, the stage restarts at that
    step and trains only the epochs left."""
    _, cfg = _cfgs("clip_bottleneck_linear_eval", tmp_path)
    cfg = tconfig.apply_precision(cfg)
    real_save = tckpt.CheckpointManager.save_last

    class Killed(Exception):
        pass

    def save_then_die(self, state, step):
        real_save(self, state, step)
        raise Killed

    monkeypatch.setattr(tckpt.CheckpointManager, "save_last", save_then_die)
    first = []
    with pytest.raises(Killed):
        trun.run_featurizer_stage(dataclasses.replace(cfg), device="cpu",
                                  on_step=lambda s, *_: first.append(s),
                                  log=lambda _: None)
    monkeypatch.setattr(tckpt.CheckpointManager, "save_last", real_save)
    second = []
    state, *_ = trun.run_featurizer_stage(
        dataclasses.replace(cfg), device="cpu",
        on_step=lambda s, *_: second.append(s), log=lambda _: None)
    spe = len(first)
    assert spe > 0 and first == list(range(spe))
    assert second == list(range(spe, 2 * spe)) and state.step == 2 * spe
    with (Path(cfg.stage_dir) / "train_featurizer.csv").open() as f:
        val_rows = [r for r in csv.DictReader(f) if r.get("val/feat/loss")]
    assert len(val_rows) == 2   # one a run: the resumed run ran one epoch
