"""The banana experiments on the port against the JAX package.

The same seeded inputs go through the JAX functions and their
counterparts in the port:

* the host `BananaDataset`: data, targets, quantiles and batches equal
  byte for byte under every equivalence x additional target;
* the device sampler: its exact invariants (to 1e-5), and its means and
  covariances over 200,000 draws against JAX's `device_sample_batch`
  (`jax.random` and torch draw different numbers): means within 0.04 and
  covariances within 0.15, about 5 standard errors of the difference of
  two independent 200,000-draw estimates (measured: 0.005-0.009 and
  0.003-0.038);
* the `MI` rate (both families) and the KL helpers, the direct distortion
  in training and in evaluation with its BatchNorm running statistics
  (fp32, rel 1e-5 / abs 1e-6);
* 3 training steps of each banana preset at small widths from JAX's
  initial weights on the same host batches and draws: logs and parameters
  (BatchNorm running statistics included) at rel 1e-5 / abs 1e-6, or
  within twice JAX's spread against itself, from its weights moved by one
  ulp (4 such starts, `preset_steps`): `banana_viz_BINCE`'s 1-d cosine
  projection is the sign of its input, so its gradients are roundoff
  amplified (some are 0 but for roundoff) and Adam's first steps turn
  them into +-lr; JAX itself moves by up to 2 x lr there;
* the fused epoch (`make_generative_epoch`) on the CPU, and a featurizer
  stage killed after its first epoch and resumed, equal to an unbroken
  run;
* `main` on all five presets and the experiment CLI (`--device cpu
  --dev`), writing JAX's results-CSV keys for the three stages, and `-m`
  giving one job a swept value.
"""

import csv
import dataclasses
import functools
import itertools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors import distortions as jdist
from lossyless_tpu.compressors import distributions as jdistr
from lossyless_tpu.compressors import rates as jrates
from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.data import banana as jbanana
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import distortions as tdist
from lossyless_tpu_torch.compressors import distributions as tdistr
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.data import banana as tbanana
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.nn.mlp import params_from_flax
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train import state as tstate

EQUIVALENCES = ["rotation", "x_translation", "y_translation", None]
TARGETS = ["representative", "input", "equiv_x", "target"]
TOL = dict(rtol=1e-5, atol=1e-6)
PRESETS = ["banana_viz_VIC", "banana_viz_VAE", "banana_viz_BINCE",
           "banana_viz_VIC_trnslt", "banana_RD"]


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eq,at", itertools.product(EQUIVALENCES, TARGETS))
def test_host_dataset_is_jaxs_bytes(eq, at):
    kw = dict(length=300, equivalence=eq, additional_target=at, seed=7)
    j, t = jbanana.BananaDataset(**kw), tbanana.BananaDataset(**kw)
    for name in ("data", "targets", "min_x", "min_y", "max_x", "max_y"):
        a, b = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    jb = list(j.batches(64, n_epochs=2, seed=3))
    tb = list(t.batches(64, n_epochs=2, seed=3))
    assert len(jb) == len(tb) == 8
    for jbatch, tbatch in zip(jb, tb):
        for a, b in zip(jbatch, tbatch):
            assert isinstance(b, torch.Tensor)
            assert a.dtype == b.numpy().dtype and \
                a.tobytes() == b.numpy().tobytes()
    # the datamodule registry and the pipeline build the same dataset
    ds = timages.get_datamodule("banana", **kw)
    assert ds.data.tobytes() == t.data.tobytes()


@pytest.mark.parametrize("eq", ["rotation", "x_translation",
                                "y_translation"])
@pytest.mark.parametrize("at", TARGETS)
def test_device_sampler_invariants(eq, at):
    ds = tbanana.BananaDataset(length=8, equivalence=eq, additional_target=at)
    x, mx, aux = ds.device_sampler(4096)(torch.Generator().manual_seed(1))
    assert x.shape == (4096, 2) and mx.shape == (4096, 1)
    x, mx, aux = x.numpy(), mx.numpy(), aux.numpy()
    # the host dataset's invariant and representative of the same points
    host = tbanana.BananaDataset(length=1, equivalence=eq)
    np.testing.assert_allclose(host.max_invariant(x), mx, atol=1e-5)
    rep = host.representative(mx)
    if at == "representative":
        np.testing.assert_allclose(aux, rep, atol=1e-5)
    elif at == "input":
        np.testing.assert_array_equal(aux, x)
    elif at == "equiv_x":   # the same orbit
        np.testing.assert_allclose(host.max_invariant(aux), mx, atol=1e-5)
        assert not np.allclose(aux, x)
    else:
        np.testing.assert_array_equal(aux, mx)
    if eq != "rotation":
        # translation keeps the invariant coordinate, moves the other one
        # within the source's 10-90% range
        axis = 0 if eq == "y_translation" else 1
        np.testing.assert_array_equal(x[:, axis:axis + 1], mx)
        if at == "representative":
            lo, hi = tbanana.TRANSLATION_RANGE[1 - axis]
            assert lo <= x[:, 1 - axis].min() < x[:, 1 - axis].max() <= hi


@pytest.mark.parametrize("eq,at", itertools.product(EQUIVALENCES, TARGETS))
def test_device_sampler_moments_match_jax(eq, at):
    n = 200_000
    want = jbanana.device_sample_batch(jax.random.key(0), n, eq, at)
    got = tbanana.device_sample_batch(torch.Generator().manual_seed(0), n,
                                      eq, at)
    for j, t in zip(want, got):
        j, t = np.asarray(j, np.float64), t.double().numpy()
        assert j.shape == t.shape
        np.testing.assert_allclose(t.mean(0), j.mean(0), atol=0.04)
        np.testing.assert_allclose(np.atleast_2d(np.cov(t.T)),
                                   np.atleast_2d(np.cov(j.T)), atol=0.15)


# ---------------------------------------------------------------------------
# The MI rate, the KL helpers, the direct distortion
# ---------------------------------------------------------------------------


def _merge(params, stats) -> dict:
    """flax params and batch_stats -> one nested tree of numpy arrays."""
    out = {k: (dict(v) if isinstance(v, dict) else np.asarray(v))
           for k, v in params.items()}
    for k, v in stats.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) \
            else np.asarray(v)
    return out


def _gaussians(seed=0, b=6, z=3):
    s = np.random.default_rng(seed).normal(size=(b, 2 * z)).astype(
        np.float32)
    return (jdistr.from_suff_param("diaggaussian", jnp.asarray(s)),
            tdistr.from_suff_param("diaggaussian", torch.from_numpy(s)))


@pytest.mark.parametrize("family", ["deterministic", "diaggaussian"])
def test_mi_rate_matches_jax(family):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(6, 3)).astype(np.float32)
    if family == "diaggaussian":
        jp, tp = _gaussians()
    else:
        jp = jdistr.Deterministic(jnp.asarray(z))
        tp = tdistr.Deterministic(torch.from_numpy(z))
    jz, jr, jlogs = jrates.MIRate(3).apply({}, jnp.asarray(z), jp,
                                          training=True)
    rate = trates.make_rate_estimator(3, trates.RateConfig(mode="MI"))
    tz = torch.from_numpy(z).requires_grad_(True)
    z_hat, tr, tlogs = rate(tz, tp, training=True)
    assert z_hat is tz
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr), **TOL)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(tlogs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5,
                                                abs=1e-6), k
    # detached, the rates are the same and carry no gradient to z
    _, tr_det, _ = rate(tz, tp, training=True, detach_rate=True)
    assert torch.equal(tr_det, tr) and not tr_det.requires_grad


def test_kl_helpers_match_jax():
    jp, tp = _gaussians(2)
    np.testing.assert_allclose(tdistr.kl_unit_gaussian(tp).numpy(),
                               np.asarray(jdistr.kl_unit_gaussian(jp)), **TOL)
    rng = np.random.default_rng(3)
    q_loc = rng.normal(size=(6, 3)).astype(np.float32)
    q_scale = rng.uniform(0.5, 2, size=(6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tdistr.kl_divergence(tp, torch.from_numpy(q_loc),
                             torch.from_numpy(q_scale)).numpy(),
        np.asarray(jdistr.kl_divergence(jp, q_loc, q_scale)), **TOL)
    # a deterministic p: the cross-entropy at the given samples
    z = rng.normal(size=(6, 3)).astype(np.float32)
    jd = jdistr.Deterministic(jnp.asarray(z))
    td = tdistr.Deterministic(torch.from_numpy(z))
    np.testing.assert_allclose(
        tdistr.kl_divergence(td, torch.from_numpy(q_loc), 1.5).numpy(),
        np.asarray(jdistr.kl_divergence(jd, q_loc, 1.5)), **TOL)
    np.testing.assert_allclose(
        tdistr.kl_divergence(td, 0.0, torch.from_numpy(q_scale),
                             z_samples=torch.from_numpy(q_loc)).numpy(),
        np.asarray(jdistr.kl_divergence(jd, 0.0, q_scale,
                                        z_samples=q_loc)), **TOL)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("mode", ["distribution", "feature"])
def test_direct_distortion_matches_jax(training, mode):
    rng = np.random.default_rng(4)
    z = rng.normal(size=(32, 2)).astype(np.float32)
    y = rng.normal(size=(32, 2)).astype(np.float32)
    kw = dict(hid_dim=16, n_hid_layers=2, norm_layer="batchnorm",
              activation="quickgelu")
    cfg = dict(mode="direct", data_mode=mode, is_classification=False,
               arch_kwargs=kw)
    jm = jdist.DirectDistortion(2, 2, jdist.DistortionConfig(**cfg))
    v = jm.init(jax.random.key(0), jnp.asarray(z), jnp.asarray(y),
                training=True)
    # running statistics away from their init, so evaluation reads them
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(
        0.1, 0.5, a.shape).astype(np.float32), v["batch_stats"])
    out, new = jm.apply({"params": v["params"], "batch_stats": stats},
                        jnp.asarray(z), jnp.asarray(y), training=training,
                        mutable=["batch_stats"])
    (jloss, jlogs) = out
    tm = tdist.make_distortion_estimator(tdist.DistortionConfig(**cfg), 2, 2)
    tm.load_state_dict(params_from_flax(_merge(v["params"], stats)))
    tloss, tlogs = tm(torch.from_numpy(z), torch.from_numpy(y),
                      training=training)
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               **TOL)
    assert float(tlogs["H_q_TlZ"]) == pytest.approx(
        float(jlogs["H_q_TlZ"]), rel=1e-5)
    want = params_from_flax(new["batch_stats"])
    for k, w in want.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), w.numpy(),
                                   err_msg=k, **TOL)
    with torch.no_grad():
        rec = tm.reconstruct(torch.from_numpy(z))
    # from the running statistics the step left (training updates them)
    jrec = jm.apply({"params": v["params"],
                     "batch_stats": new["batch_stats"]},
                    jnp.asarray(z), method="reconstruct")
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **TOL)


# ---------------------------------------------------------------------------
# 3 training steps of each preset
# ---------------------------------------------------------------------------

SMALL = ["encoder.arch_kwargs.hid_dim=32", "distortion.arch_kwargs.hid_dim=32",
         "online.arch_kwargs.hid_dim=16", "data_feat.batch_size=64"]
STEPS, B = 3, 64
SPREAD_RUNS = 4   # JAX runs from one-ulp moves of its start


def _one_ulp(tree, seed: int):
    """Every value of a flax tree moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        return np.where(rng.integers(0, 2, a.shape) == 1,
                        np.nextafter(a, np.inf), np.nextafter(a, -np.inf)
                        ).astype(a.dtype)
    return jax.tree.map(move, tree)


def _uniform(key, n: int, z: int) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.uniform(
        key, (n, z), jnp.float32, -0.5, 0.5)))


def _normal(key, n: int, z: int) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.normal(key, (n, z),
                                                       jnp.float32)))


def _draws(cfg, step: int) -> dict:
    """The draws JAX's train_step makes with `jax.random.key(step)`, in
    the port's form (`compressor.py`: the anchor's sample from
    split(key, 4)[0] and its rate noise from [1], the positive's from [2]
    and [3]; fused views: one 2B draw each from [0] and [1])."""
    keys = jax.random.split(jax.random.key(step), 4)
    z = cfg.encoder.z_dim
    gauss = cfg.encoder.family == "diaggaussian"
    uses_noise = cfg.rate.mode in ("H_factorized", "H_hyper")
    if cfg.distortion.mode != "contrastive":
        return dict(noise=_uniform(keys[1], B, z) if uses_noise else None,
                    eps=_normal(keys[0], B, z) if gauss else None)
    if cfg.distortion.concat_views:
        noise, eps = _uniform(keys[1], 2 * B, z), _normal(keys[0], 2 * B, z)
        noise, eps = (noise[:B], noise[B:]), (eps[:B], eps[B:])
    else:
        noise = _uniform(keys[1], B, z), _uniform(keys[3], B, z)
        eps = _normal(keys[0], B, z), _normal(keys[2], B, z)
    return dict(noise=noise if uses_noise else None,
                eps=eps if gauss else None)


@functools.lru_cache(maxsize=None)
def preset_steps(name: str, extra: tuple = ()):
    """JAX's and the port's logs and variables after STEPS steps of
    `name` at small widths from JAX's initial weights, and JAX's own
    roundoff spread: the largest deviation of its runs from those weights
    moved by one ulp (per log, and per variable)."""
    ov = SMALL + list(extra)
    jcfg = jconfig.apply_overrides(jconfig.preset(name), ov)
    tcfg = tconfig.apply_overrides(tconfig.preset(name), ov)
    data = dataclasses.replace(tcfg.data_feat, kwargs={
        **tcfg.data_feat.kwargs, "length": 4 * B})
    ds = trun.instantiate_datamodule(tcfg, data)
    jcfg.in_shape, jcfg.target_shape, jcfg.aux_shape = \
        tcfg.in_shape, tcfg.target_shape, tcfg.aux_shape
    batches = [tuple(t.numpy() for t in b)
               for b in itertools.islice(ds.batches(B, seed=0), STEPS)]

    model = JLC(jcfg.compressor_config())
    opts = [jstate.bind_schedule_steps(o, STEPS, STEPS)
            for o in (jcfg.optimizer_feat, jcfg.optimizer_online,
                      jcfg.optimizer_coder)]
    state0 = jstate.TrainState.create(
        model, tuple(map(jnp.asarray, batches[0])),
        jax.random.key(jcfg.trainer.seed), main=opts[0], online=opts[1],
        coder=opts[2])
    start = (jax.tree.map(np.asarray, state0.params),
             jax.tree.map(np.asarray, state0.batch_stats))

    def jax_run(params):
        # train_step donates its state: each run starts from a copy
        state = jax.tree.map(jnp.copy, state0).replace(
            params=jax.tree.map(jnp.asarray, params))
        logs = []
        for step, batch in enumerate(batches):
            state, lg = jstate.train_step(
                state, tuple(map(jnp.asarray, batch)), jax.random.key(step))
            logs.append({k: float(v) for k, v in lg.items()})
        return logs, tcomp.compressor_params_from_flax(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))

    jlogs, jvars = jax_run(start[0])
    # JAX's own spread: the largest deviation over SPREAD_RUNS starts
    runs = [jax_run(_one_ulp(start[0], seed)) for seed in range(SPREAD_RUNS)]
    slogs = [{k: max(abs(r[0][i][k] - jlogs[i][k]) for r in runs)
              for k in jlogs[i]} for i in range(STEPS)]
    svars = {k: np.max([np.abs(r[1][k].numpy() - w.numpy()) for r in runs])
             for k, w in jvars.items()}

    tstate_ = trun.build_state(tcfg, STEPS, STEPS, device="cpu")
    tstate_.model.load_state_dict(tcomp.compressor_params_from_flax(*start))
    tlogs = []
    for step, batch in enumerate(batches):
        tstate_, lg = tstate.train_step(
            tstate_, tuple(map(torch.from_numpy, batch)),
            **_draws(tcfg, step))
        tlogs.append({k: float(v) for k, v in lg.items()})
    return jlogs, jvars, slogs, svars, tlogs, tstate_.model.state_dict()


def _close_or_within_spread(got, want, spread: float, what):
    """rel 1e-5 / abs 1e-6, else at most twice JAX's own spread (the
    largest deviation of its one-ulp starts)."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    diff = np.abs(got - want)
    if np.all(diff <= 1e-6 + 1e-5 * np.abs(want)):
        return
    assert diff.max() <= 2 * spread, (what, diff.max(), spread)


def check_preset_steps(name: str, extra: tuple = ()):
    jlogs, jvars, slogs, svars, tlogs, tvars = preset_steps(name, extra)
    for step, (j, s, t) in enumerate(zip(jlogs, slogs, tlogs)):
        assert set(t) == set(j), (step, set(t) ^ set(j))
        for k in j:
            # I_q_zm = hat_H_m - the cross-entropy: held as the
            # cross-entropy it is taken from (rel 1e-5), not as a
            # difference near 0
            got, want = ((d["hat_H_m"] - d[k]) if k == "I_q_zm" else d[k]
                         for d in (t, j))
            _close_or_within_spread(got, want, s[k], (step, k))
    assert set(tvars) == set(jvars)
    # the BatchNorm running statistics are among them
    assert any(k.endswith("BatchNorm_1.var") for k in tvars)
    for k, w in jvars.items():
        _close_or_within_spread(tvars[k].numpy(), w.numpy(), svars[k], k)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_steps_match_jax(name):
    check_preset_steps(name)


def test_strict_tolerance_holds_where_jax_reproduces_itself():
    """For the direct-distortion presets JAX's own spread stays inside rel
    1e-5 / abs 1e-6: the port is held to that tolerance alone there."""
    jlogs, jvars, _, _, tlogs, tvars = preset_steps("banana_viz_VIC")
    for j, t in zip(jlogs, tlogs):
        for k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-6), k
    for k, w in jvars.items():
        np.testing.assert_allclose(tvars[k].numpy(), w.numpy(), err_msg=k,
                                   **TOL)


# ---------------------------------------------------------------------------
# The fused epoch, and a killed stage that resumes
# ---------------------------------------------------------------------------

TINY = ["encoder.arch_kwargs.hid_dim=16", "distortion.arch_kwargs.hid_dim=16",
        "online.arch_kwargs.hid_dim=8", "data_feat.batch_size=64",
        "data_feat.val_batch_size=128", "data_feat.kwargs.length=512",
        "data_feat.n_epochs=2", "predictor.n_epochs=1",
        "predictor.arch_kwargs.hid_dim=16", "predictor.batch_size=64",
        "trainer.log_every=2"]


def _tiny(name: str, root, extra=()):
    return tconfig.apply_overrides(tconfig.preset(name), TINY + [
        f"out_dir={root}/out", f"ckpt_dir={root}/ckpt", *extra])


def _fresh_state(cfg, ds):
    trun.instantiate_datamodule(cfg, cfg.data_feat)
    return trun.build_state(cfg, 8, 4, device="cpu")


def test_generative_epoch_draws_on_the_device_and_reads_back_once():
    cfg = _tiny("banana_viz_BINCE", "/nonexistent")
    ds = trun.instantiate_datamodule(cfg, cfg.data_feat)
    sampler = ds.device_sampler(64)
    seen = []

    def sample(generator):
        seen.append(generator)
        return sampler(generator)

    epoch = tstate.make_generative_epoch(sample, 4)
    a, b, c = (_fresh_state(cfg, ds) for _ in range(3))
    a, logs_a = epoch(a, 5)
    assert a.step == 4 and len(seen) == 4 and len({id(g) for g in seen}) == 1
    for k, v in logs_a.items():
        assert isinstance(v, np.ndarray) and v.shape == (4,), k
    assert np.isfinite(logs_a["loss"]).all() and "I_q_zm" in logs_a
    # the epoch is a function of the state and the seed alone
    b, logs_b = epoch(b, 5)
    c, logs_c = epoch(c, 6)
    for k in logs_a:
        np.testing.assert_array_equal(logs_b[k], logs_a[k])
    assert not np.array_equal(logs_c["loss"], logs_a["loss"])
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    # the batches' and the steps' generators are distinct streams
    g_data, g_step = tstate.epoch_generators(5, "cpu")
    assert not torch.equal(torch.rand(8, generator=g_data),
                           torch.rand(8, generator=g_step))


def test_fused_stage_killed_and_resumed_equals_an_unbroken_run(tmp_path):
    cfg = tconfig.apply_precision(_tiny("banana_viz_VIC", tmp_path / "a"))
    whole = []
    trun.run_featurizer_stage(
        dataclasses.replace(cfg), device="cpu", log=lambda _: None,
        on_step=lambda s, *_: whole.append(s))

    cfg_b = tconfig.apply_overrides(cfg, [f"out_dir={tmp_path}/b/out",
                                          f"ckpt_dir={tmp_path}/b/ckpt"])

    class Killed(Exception):
        pass

    real_save = tckpt.CheckpointManager.save_last

    def save_then_die(self, st, step):
        real_save(self, st, step)
        raise Killed

    first, second = [], []
    tckpt.CheckpointManager.save_last = save_then_die
    try:
        with pytest.raises(Killed):
            trun.run_featurizer_stage(
                dataclasses.replace(cfg_b), device="cpu",
                log=lambda _: None, on_step=lambda s, *_: first.append(s))
    finally:
        tckpt.CheckpointManager.save_last = real_save
    trun.run_featurizer_stage(
        dataclasses.replace(cfg_b), device="cpu", log=lambda _: None,
        on_step=lambda s, *_: second.append(s))
    spe = len(first)
    assert spe == 8 and first + second == whole == list(range(2 * spe))
    # the two runs' last checkpoints: model (BatchNorm statistics
    # included), optimizers and step, equal. (Each stage returns its best
    # state: the killed run died before the first epoch's best was kept.)
    last = []
    for c in (cfg, cfg_b):
        st = _fresh_state(c, None)
        tckpt.CheckpointManager(
            Path(c.ckpt_dir) / c.long_name / "feat").restore(st, "last")
        last.append(st.state_dict())
    assert last[0]["step"] == last[1]["step"] == 2 * spe
    for k, v in last[0]["model"].items():
        assert torch.equal(v, last[1]["model"][k]), k
    assert repr(last[0]["optimizers"]) == repr(last[1]["optimizers"])
    # the fused epochs logged a row of window means every 2 steps
    with (Path(cfg.stage_dir) / "train_featurizer.csv").open() as f:
        rows = list(csv.DictReader(f))
    train_steps = [int(r["step"]) for r in rows if r.get("train/feat/loss")]
    assert train_steps == list(range(2, 2 * spe + 1, 2))


# ---------------------------------------------------------------------------
# main and the experiment CLI
# ---------------------------------------------------------------------------

STAGES = ("featurizer", "communication", "predictor")


def _csv_keys(stage_dir, stage):
    with (Path(stage_dir) / f"results_{stage}.csv").open() as f:
        return next(csv.reader(f))


def jax_results_keys(name: str, root) -> dict:
    """The results-CSV keys of JAX's `main` of `name` at the tiny size."""
    cfg = jconfig.apply_overrides(jconfig.preset(name), TINY + [
        f"out_dir={root}/out", f"ckpt_dir={root}/ckpt"])
    jrun.main(cfg)
    return {s: _csv_keys(cfg.stage_dir, s) for s in STAGES}


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """JAX's results-CSV keys of the direct-distortion banana presets."""
    return jax_results_keys("banana_viz_VIC", tmp_path_factory.mktemp("jax"))


@pytest.mark.parametrize("name", [n for n in PRESETS if "BINCE" not in n])
def test_main_writes_jaxs_results(name, jax_keys, tmp_path):
    cfg = _tiny(name, tmp_path)
    metrics = trun.main(cfg, device="cpu")
    for stage in STAGES:
        assert (Path(cfg.stage_dir) / f"{stage}_end.txt").exists()
        assert _csv_keys(cfg.stage_dir, stage) == jax_keys[stage], stage
    assert math.isfinite(metrics["test/pred/loss"])
    assert metrics["test/comm/n_bits"] > 0
    assert "test/pred/acc" not in metrics   # the regression probe


def test_main_with_the_mi_rate_writes_jaxs_results(tmp_path):
    """A Gaussian encoder with the MI rate: no coder, the communication
    stage reports the bound (`rate`, `is_real_coding` 0)."""
    extra = ["encoder.family=diaggaussian", "rate.mode=MI"]
    jcfg = jconfig.apply_overrides(jconfig.preset("banana_viz_VIC"), TINY + [
        f"out_dir={tmp_path}/jax/out", f"ckpt_dir={tmp_path}/jax/ckpt",
        *extra])
    jrun.main(jcfg)
    cfg = _tiny("banana_viz_VIC", tmp_path / "port", extra)
    metrics = trun.main(cfg, device="cpu")
    for stage in STAGES:
        assert _csv_keys(cfg.stage_dir, stage) == \
            _csv_keys(jcfg.stage_dir, stage), stage
    assert metrics["test/comm/is_real_coding"] == 0.0
    assert metrics["test/comm/rate"] > 0 and \
        math.isfinite(metrics["test/feat/I_q_ZX"])


def test_cli_runs_a_preset_on_the_cpu(jax_keys, tmp_path, capsys):
    argv = ["banana_viz_VAE", "--dev", "--device", "cpu", *TINY,
            f"out_dir={tmp_path}/out", f"ckpt_dir={tmp_path}/ckpt"]
    metrics = tcli.main(argv)
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == set(metrics) and "test/comm/n_bits" in printed
    cfg = tconfig.apply_overrides(tconfig.preset("banana_viz_VAE"), argv[4:])
    for stage in STAGES:
        assert _csv_keys(cfg.stage_dir, stage) == jax_keys[stage], stage


def test_cli_multirun_gives_a_job_a_value(tmp_path, capsys):
    argv = ["banana_RD", "-m", "--dev", "--device", "cpu", *TINY,
            "data_feat.n_epochs=1", f"out_dir={tmp_path}/out",
            f"ckpt_dir={tmp_path}/ckpt", "loss.beta=0.05,0.2"]
    jobs = tcli.main(argv)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [j["job"] for j in jobs] == [0, 1] and lines == jobs
    assert [j["overrides"][-1] for j in jobs] == ["loss.beta=0.05",
                                                   "loss.beta=0.2"]
    betas = sorted(p.name for p in (tmp_path / "out").rglob("beta_*"))
    assert betas == ["beta_2.0e-01", "beta_5.0e-02"]
    # a repeated combination gets the -run{i} suffix
    again = tcli.main(argv[:-1] + ["loss.beta=0.05,0.05"])
    assert len(again) == 2
    assert (tmp_path / "out" / "exp_banana_RD-run1").exists()


def test_cli_refuses_what_is_not_ported(tmp_path):
    """`--classical` still raises naming its item; `--profile-dir`, ported
    since, traces the run into the directory."""
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tcli.main(["banana_viz_VIC", "--classical", "jpeg"])
    metrics = tcli.main(["banana_viz_VIC", "--dev", "--device", "cpu", *TINY,
                         "data_feat.n_epochs=1", f"out_dir={tmp_path}/out",
                         f"ckpt_dir={tmp_path}/ckpt", "--profile-dir",
                         str(tmp_path / "trace")])
    assert math.isfinite(metrics["test/feat/loss"])
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert events["traceEvents"]
