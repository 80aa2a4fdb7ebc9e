"""Port training path of the hub compressor (clip_hub) against JAX.

The same seeded inputs, made with numpy (or drawn with jax.random where
JAX draws them, then handed over), go through the JAX functions and their
counterparts in the port: the annealer, the step schedules, the three
optimizers, the group labels, the factorized rate with K3 on, the lossy-Z
distortion, and a tiny clip_hub-shaped compressor trained for 3 steps
with the K3/K4 overrides on. The JAX Pallas kernels run in interpret mode;
the port's kernels take their plain versions on CPU tensors.

Tolerances, with their reasons:
* schedules rtol 1e-5, atol 1e-6 of the lr (optax evaluates in fp32,
  the port in float64; the cosine's tail is a difference near zero);
* the annealer rtol 1e-6 (float32; XLA may fuse the multiply-add);
* optimizer parameters after 12 updates rtol 1e-4 / atol 1e-5 (torch and
  optax order the Adam arithmetic differently, and each side computes the
  next gradient from its own parameters);
* the rate estimator: z_hat 1e-5, rates rtol 1e-4 (the fp32 chain in
  another summation order, tests/test_pallas_eb.py's tolerances);
* the 3-step slice in fp32: logs rtol 1e-5; parameters rtol 1e-4 (they
  went through Adam) with atol 1e-5, 1% of the first step's lr: at step 0
  the annealed beta is 5e-7 and the distortion's gradient with respect to
  the affine's biasing is 0 analytically, so some gradients sit within
  roundoff of Adam's eps (1e-8), and their normalized updates differ by up
  to that much between any two fp32 evaluations;
* the same in bf16 at the tower's bf16 tolerance of the slice-1 tests
  (atol 5e-2 on what the tower's output sets: z and the distortion).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lossyless_tpu.compressors import rates as jrates
from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.core.annealer import Annealer as JAnnealer
from lossyless_tpu.hub import save_hub as jsave
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import distortions as tdist
from lossyless_tpu_torch.compressors import distributions as tdistr
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.core.annealer import Annealer as TAnnealer
from lossyless_tpu_torch.hub import save_hub as tsave
from lossyless_tpu_torch.nn import registry
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import state as tstate
from tests import torch_threads  # noqa: F401  (one pool a worker)


# ---------------------------------------------------------------------------
# Annealer, schedules, optimizers, group labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,ini,fin,n,start", [
    ("linear", 1e-5, 0.05, 10, 0), ("geometric", 1e-5, 0.05, 10, 2),
    ("constant", 1.0, 0.3, 5, 0), ("linear", 0.05, 1e-5, -7, 0)])
def test_annealer_matches_jax(mode, ini, fin, n, start):
    j = JAnnealer(ini, fin, n, start_step=start, mode=mode)
    t = TAnnealer(ini, fin, n, start_step=start, mode=mode)
    for step in range(-1, 16):
        assert t(step) == pytest.approx(float(j(step)), rel=1e-6), step


SCHEDULES = [
    dict(scheduler="none"),
    dict(scheduler="expdecay", decay_factor=100.0, total_steps=40),
    dict(scheduler="unifmultistep", decay_factor=1000.0, total_steps=40),
    dict(scheduler="unifmultistep", decay_factor=1000.0, total_steps=3),
    dict(scheduler="cosine", total_steps=40),
    dict(scheduler="cosine_restart", total_steps=40, steps_per_epoch=2,
         restart_t0_epochs=2, restart_mult=2),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[s["scheduler"] + str(
    s.get("total_steps", "")) for s in SCHEDULES])
def test_schedules_match_optax(kw):
    cfg_j = jstate.OptimConfig(lr=1e-3, **kw)
    cfg_t = tstate.OptimConfig(lr=1e-3, **kw)
    j = jstate._make_schedule(cfg_j)
    t = tstate._make_schedule(cfg_t)
    # past every unifmultistep boundary and every restart
    for count in range(0, 50):
        want = float(j(count)) if callable(j) else j
        assert t(count) == pytest.approx(want, rel=1e-5, abs=1e-9), count


def test_plateau_and_binding():
    # plateau is host-driven: a constant lr (times the controller's scale)
    for kw in (dict(), dict(total_steps=100)):
        sched = tstate._make_schedule(tstate.OptimConfig(
            scheduler="plateau", lr=0.3, **kw))
        assert [sched(c) for c in (0, 50, 99)] == [0.3] * 3
        assert jstate._make_schedule(jstate.OptimConfig(
            scheduler="plateau", lr=0.3, **kw)) == 0.3
    for kw in (dict(scheduler="unifmultistep", total_steps=0),
               dict(scheduler="none", total_steps=0),
               dict(scheduler="cosine_restart", total_steps=0)):
        j = jstate.bind_schedule_steps(jstate.OptimConfig(**kw), 30, 5)
        t = tstate.bind_schedule_steps(tstate.OptimConfig(**kw), 30, 5)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("mode,wd,sched", [
    ("adamw", 3e-2, "unifmultistep"), ("adam", 0.0, "expdecay"),
    ("adam", 1e-2, "none"), ("sgd", 1e-2, "cosine")])
def test_optimizers_match_optax(mode, wd, sched):
    """12 updates of a toy quadratic with the gradients handed to both."""
    cfg_kw = dict(mode=mode, lr=3e-2, weight_decay=wd, scheduler=sched,
                  decay_factor=100.0, total_steps=12)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    target = rng.normal(size=(5, 3)).astype(np.float32)
    tx = jstate.make_optimizer(jstate.OptimConfig(**cfg_kw))
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tstate.make_optimizer(tstate.OptimConfig(**cfg_kw), [tp])
    sched_t = tstate._make_schedule(tstate.OptimConfig(**cfg_kw))
    for count in range(12):
        g = (np.asarray(jp) - target) ** 3        # a gradient of each side's
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = (tp.detach() - torch.from_numpy(target)) ** 3
        tp.grad = tg
        for group in opt.param_groups:
            group["lr"] = sched_t(count)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-4, atol=1e-5)


def test_group_labels_with_frozen():
    names = ["p_ZlX.mapper.blocks.0.mlp_fc.kernel",
             "rate_estimator.affine.scaling",
             "rate_estimator.entropy_bottleneck.matrix0",
             "rate_estimator.entropy_bottleneck.quantiles",
             "online_evaluator.model.kernel"]
    assert [tstate.param_label(n, ("p_ZlX",)) for n in names] == [
        "frozen", "main", "main", "coder", "online"]
    assert tstate.param_label(names[0]) == "main"
    # the JAX labelling of the same paths
    tree = {"p_ZlX": {"mapper": {"k": 0}},
            "rate_estimator": {"affine": {"scaling": 0},
                               "entropy_bottleneck": {"matrix0": 0,
                                                      "quantiles": 0}},
            "online_evaluator": {"model": {"kernel": 0}}}
    want = {}

    def label(path, _):
        keys = [p.key for p in path]
        lbl = "frozen" if "p_ZlX" in keys else jstate._param_label(path)
        want[".".join(keys)] = lbl
        return lbl

    jax.tree_util.tree_map_with_path(label, tree)
    got = {n: tstate.param_label(n, ("p_ZlX",)) for n in want}
    assert got == want


# ---------------------------------------------------------------------------
# Rate, distortion, distributions, registry
# ---------------------------------------------------------------------------


def _jax_noise(step, shape):
    """The rate's noise as the JAX step draws it (compressor.py:185,
    rates.py:191, entropy_bottleneck.py:124-130)."""
    key = jax.random.split(jax.random.key(step), 4)[1]
    return np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


@pytest.mark.parametrize("training", [True, False])
def test_factorized_rate_with_k3_matches_jax(training):
    C, B = 20, 32
    z = (np.random.default_rng(0).normal(size=(B, C)) * 4).astype(np.float32)
    cfg = jrates.RateConfig(eb_use_pallas=True, eb_filters=(3, 3, 3, 3))
    jm = jrates.HRateFactorizedPrior(C, cfg)
    v = jm.init({"params": jax.random.key(1)}, jnp.asarray(z), None,
                training=True, rng=jax.random.key(2))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32), v["params"])
    key = jax.random.key(3)
    jz_hat, jrates_, jlogs = jm.apply({"params": params}, jnp.asarray(z),
                                      None, training=training, rng=key)
    noise = np.asarray(jax.random.uniform(key, (B, C), jnp.float32, -0.5,
                                          0.5))

    tm = trates.HRateFactorizedPrior(C, trates.RateConfig(
        eb_use_pallas=True, eb_filters=(3, 3, 3, 3)))
    tm.load_state_dict({f"{sub}.{k}": torch.from_numpy(np.asarray(val))
                        for sub in params for k, val in params[sub].items()})
    with torch.no_grad():
        tz_hat, trates_, tlogs = tm(torch.from_numpy(z), None,
                                    training=training,
                                    noise=torch.from_numpy(noise))
    np.testing.assert_allclose(tz_hat.numpy(), np.asarray(jz_hat),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trates_.numpy(), np.asarray(jrates_),
                               rtol=1e-4)
    assert float(tlogs["H_q_Z"]) == pytest.approx(float(jlogs["H_q_Z"]),
                                                  rel=1e-4)


def test_detached_rate_is_one_likelihood_with_live_z_hat():
    """is_endToEnd=False: rates see a detached z, z_hat stays live."""
    tm = trates.HRateFactorizedPrior(6, trates.RateConfig())
    z = torch.randn(5, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    noise = torch.rand(5, 6, generator=torch.Generator().manual_seed(1)) - .5
    z_hat, rates, _ = tm(z, None, training=True, noise=noise,
                         detach_rate=True)
    (gz,) = torch.autograd.grad(rates.sum(), z, allow_unused=True)
    assert gz is None
    (gz,) = torch.autograd.grad(z_hat.sum(), z)
    assert torch.allclose(gz, torch.ones_like(gz))
    ref_hat, ref_rates, _ = tm(z, None, training=True, noise=noise)
    assert torch.equal(z_hat, ref_hat) and torch.equal(rates, ref_rates)


def test_unported_modes_raise_and_name_the_queue():
    """H_spatial and the image mode on the BALLE decoder are ported
    (tests/test_torch_balle_spatial.py), and so are the pretrained towers
    and the ssl presets (tests/test_torch_pretrained_ssl.py) and
    galaxy_regression (tests/test_torch_galaxy.py): no preset of JAX's
    raises, and an unknown name raises JAX's ValueError."""
    assert isinstance(trates.make_rate_estimator(
        16, trates.RateConfig(mode="H_spatial", n_channels=4)),
        trates.HRateHyperpriorSpatial)
    dist = tdist.make_distortion_estimator(
        tdist.DistortionConfig(arch="balle"), 16, (32, 32, 3))
    assert type(dist.q_YlZ).__name__ == "BalleDecoder"
    assert type(registry.get_architecture(
        "clip_rn50", (32, 32, 3), 8, width=16, layers=(1, 1, 1, 1),
        heads=4)).__name__ == "ClipResNet"
    assert tconfig.preset("ssl_bottleneck_pretrain").encoder.arch == \
        "clip_rn50"
    for name in jconfig.available_presets():
        assert tconfig.preset(name).experiment == \
            jconfig.preset(name).experiment
    assert tconfig.preset("galaxy_neurips").rate.mode == "H_spatial"
    for pkg in (tconfig, jconfig):
        with pytest.raises(ValueError, match="unknown preset"):
            pkg.preset("galaxy")


@pytest.mark.parametrize("p_norm", [1.0, 2.0])
def test_lossy_z_distortion_matches_jax(p_norm):
    from lossyless_tpu.compressors import distortions as jd
    from lossyless_tpu.compressors import distributions as jdistr

    rng = np.random.default_rng(2)
    z_hat, mean = (rng.normal(size=(6, 10)).astype(np.float32)
                   for _ in range(2))
    cfg = jd.DistortionConfig(mode="lossy_Z", p_norm=p_norm)
    want, _ = jd.LossyZDistortion(cfg).apply(
        {}, jnp.asarray(z_hat), None, jdistr.Deterministic(jnp.asarray(mean)))
    got, _ = tdist.LossyZDistortion(tdist.DistortionConfig(
        mode="lossy_Z", p_norm=p_norm))(
        torch.from_numpy(z_hat), None,
        tdistr.Deterministic(torch.from_numpy(mean)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("cls,agg", [(True, "mean"), (False, "median"),
                                     (True, "std"), (False, "max")])
def test_prediction_loss_matches_jax(cls, agg):
    from lossyless_tpu.compressors import distortions as jd

    rng = np.random.default_rng(3)
    if cls:
        y_hat = rng.normal(size=(5, 4, 3)).astype(np.float32)
        y = rng.integers(0, 4, (5, 3))
    else:
        y_hat = rng.normal(size=(5, 2, 4)).astype(np.float32)
        y = rng.normal(size=(5, 2, 4)).astype(np.float32)
    want = jd.prediction_loss(jnp.asarray(y_hat), jnp.asarray(y), cls, agg)
    got = tdist.prediction_loss(torch.from_numpy(y_hat), torch.from_numpy(y),
                                cls, agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_diag_gaussian_matches_jax():
    from lossyless_tpu.compressors import distributions as jdistr

    s = np.random.default_rng(4).normal(size=(3, 8)).astype(np.float32)
    j = jdistr.from_suff_param("diaggaussian", jnp.asarray(s))
    t = tdistr.from_suff_param("diaggaussian", torch.from_numpy(s))
    z = np.random.default_rng(5).normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(z)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(z))),
                               rtol=1e-5)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()),
                               rtol=1e-5)
    assert tdistr.n_suff_params("diaggaussian") == 2
    d = tdistr.detach(tdistr.from_suff_param(
        "deterministic", torch.ones(2, 3, requires_grad=True)))
    assert not d.loc.requires_grad


def test_registry_translates_the_jax_vocabulary():
    m = registry.get_architecture(
        "clip", (64, 64, 3), 16, width=64, layers=2, heads=2,
        mlp_impl="pallas", attn_impl="einsum", dtype="float32")
    assert m.image_size == 64 and m.dtype == torch.float32
    assert [b.mlp_impl for b in m.blocks] == ["kernel", "kernel"]
    assert m.blocks[0].attn.attn_impl == "plain"
    m = registry.get_architecture("clip_vit", (32, 32, 3), 8, width=64,
                                  layers=1, heads=2, attn_impl="auto")
    assert m.dtype == torch.bfloat16 and m.blocks[0].attn.attn_impl == \
        "kernel"
    with pytest.raises(ValueError, match="square"):
        registry.get_architecture("clip", (32, 64, 3), 8)


def test_config_presets_and_overrides_match_jax():
    ov = ["rate.eb_use_pallas=True", "encoder.arch_kwargs.mlp_impl=pallas",
          "loss.beta=0.01", "trainer.log_every=5"]
    for name in ("clip_hub", "clip_bottleneck_pretrain",
                 "ssl_bottleneck_pretrain", "ssl_bottleneck_linear_eval",
                 "ssl_bottleneck_mlp_eval", "galaxy_regression"):
        j = jconfig.apply_precision(
            jconfig.apply_overrides(jconfig.preset(name), ov))
        t = tconfig.apply_precision(
            tconfig.apply_overrides(tconfig.preset(name), ov))
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd == td, name
        assert t.long_name == j.long_name
    assert tconfig.available_presets() == jconfig.available_presets()
    assert len(tconfig.available_presets()) == 28


# ---------------------------------------------------------------------------
# The slice as a whole: a tiny clip_hub-shaped compressor, 3 train steps
# ---------------------------------------------------------------------------

OVERRIDES = ["rate.eb_use_pallas=True", "encoder.arch_kwargs.mlp_impl=pallas",
             "encoder.arch_kwargs.attn_impl=pallas", "encoder.z_dim=16",
             "encoder.arch_kwargs.width=64", "encoder.arch_kwargs.layers=2",
             "encoder.arch_kwargs.heads=2", "data_feat.batch_size=4"]
IN_SHAPE, B, STEPS = (32, 32, 3), 4, 3


def _configs(dtype):
    ov = OVERRIDES + [f"encoder.arch_kwargs.dtype={dtype}"]
    j = jconfig.apply_precision(jconfig.apply_overrides(
        jconfig.preset("clip_hub"), ov))
    t = tconfig.apply_precision(tconfig.apply_overrides(
        tconfig.preset("clip_hub"), ov))
    j.in_shape = t.in_shape = IN_SHAPE
    return j, t


def _batches():
    rng = np.random.default_rng(7)
    return [(rng.normal(size=(B, *IN_SHAPE)).astype(np.float32),
             np.zeros(B, np.int32), np.zeros(B, np.float32))
            for _ in range(STEPS)]


def _jax_run(jcfg, batches):
    model = JLC(jcfg.compressor_config())
    opts = [jstate.bind_schedule_steps(o, STEPS, STEPS)
            for o in (jcfg.optimizer_feat, jcfg.optimizer_online,
                      jcfg.optimizer_coder)]
    state = jstate.TrainState.create(
        model, tuple(map(jnp.asarray, batches[0])),
        jax.random.key(jcfg.trainer.seed), main=opts[0], online=opts[1],
        coder=opts[2], frozen_paths=tuple(jcfg.frozen))
    params0 = jax.tree.map(np.asarray, state.params)
    logs = []
    for step, batch in enumerate(batches):
        state, lg = jstate.train_step(state, tuple(map(jnp.asarray, batch)),
                                      jax.random.key(step))
        logs.append({k: float(v) for k, v in lg.items()})
    return params0, jax.tree.map(np.asarray, state.params), logs


def _torch_run(tcfg, params0, batches):
    state = trun.build_state(tcfg, STEPS, STEPS, device="cpu")
    state.model.load_state_dict(tcomp.compressor_params_from_flax(params0))
    logs = []
    for step, (x, y, aux) in enumerate(batches):
        noise = torch.from_numpy(_jax_noise(step, (B, tcfg.encoder.z_dim)))
        state, lg = tstate.train_step(
            state, (torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(aux)), noise=noise)
        logs.append({k: float(v) for k, v in lg.items()})
    return state, logs


@functools.lru_cache(maxsize=None)
def _slice(dtype):
    jcfg, tcfg = _configs(dtype)
    batches = _batches()
    params0, jparams, jlogs = _jax_run(jcfg, batches)
    state, tlogs = _torch_run(tcfg, params0, batches)
    return dtype, params0, jparams, jlogs, state, tlogs


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def slice_runs(request):
    return _slice(request.param)


def test_slice_logs_match_jax(slice_runs):
    dtype, _, _, jlogs, _, tlogs = slice_runs
    for step, (j, t) in enumerate(zip(jlogs, tlogs)):
        assert set(j) == set(t), step
        for k in j:
            if dtype == "float32":
                assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-6), \
                    (step, k)
            else:
                # the bf16 tower moves z by up to the slice-1 tolerance
                assert t[k] == pytest.approx(j[k], rel=5e-2, abs=5e-2), \
                    (step, k)


def test_slice_params_match_jax(slice_runs):
    dtype, params0, jparams, _, state, _ = slice_runs
    want = tcomp.compressor_params_from_flax(jparams)
    start = tcomp.compressor_params_from_flax(params0)
    got = state.model.state_dict()
    assert set(got) == set(want)
    labels = {n: tstate.param_label(n, ("p_ZlX",)) for n in want}
    assert all(id(p) in {id(q) for opt, _ in state.optimizers.values()
                         for grp in opt.param_groups for q in grp["params"]}
               for n, p in state.model.named_parameters()
               if labels[n] != "frozen")
    for name, w in want.items():
        g = got[name].numpy()
        if labels[name] == "frozen":
            # no update on either side
            np.testing.assert_array_equal(g, start[name].numpy(), name)
            np.testing.assert_array_equal(w.numpy(), start[name].numpy(),
                                          name)
            continue
        tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else \
            dict(rtol=5e-2, atol=5e-2 * np.abs(w.numpy()).max())
        np.testing.assert_allclose(g, w.numpy(), err_msg=name, **tol)
    assert {v for v in labels.values()} == {"frozen", "main", "coder"}


def test_run_featurizer_runs_the_loop_on_the_cpu(tmp_path):
    """The entry point: the same 3 steps through run_featurizer (noise from
    a generator seeded with the step), and eval_step on the result."""
    _, tcfg = _configs("float32")
    tcfg.out_dir = str(tmp_path)
    tcfg.in_shape = None   # taken from the first batch
    tcfg.trainer.log_every = 1
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches()]
    lines, seen = [], []
    state = trun.run_featurizer(
        tcfg, batches, device="cpu", log=lines.append,
        on_step=lambda step, st, logs: seen.append(step))
    assert state.step == STEPS and seen == [0, 1, 2] and len(lines) == 3
    assert "loss=" in lines[0]
    loss, logs = tstate.eval_step(state, batches[0])
    assert torch.isfinite(loss) and "rate" in logs
    assert not any(p.requires_grad for p in state.model.p_ZlX.parameters())


def test_features_and_encode_shapes():
    _, tcfg = _configs("float32")
    model = tcomp.LearnableCompressor(tcfg.compressor_config(),
                                      frozen=tcfg.frozen)
    x = torch.from_numpy(_batches()[0][0])
    assert model.encode(x).shape == (B, 16)
    z_hat = model.features(x)
    med = model.rate_estimator.entropy_bottleneck.quantiles[:, 0, 1]
    assert z_hat.shape == (B, 16) and torch.isfinite(z_hat).all()
    assert med.shape == (16,)


# ---------------------------------------------------------------------------
# save_hub: the same files, each side reads the other's
# ---------------------------------------------------------------------------


def test_save_hub_matches_jax_and_cross_loads(tmp_path):
    _, _, jparams, _, state, _ = _slice("float32")
    jdir = jsave.save_hub(jparams, tmp_path / "jax", 0.05)
    tdir = tsave.save_hub(state.model, tmp_path / "torch", 0.05)
    assert jdir.name == tdir.name == "beta5e-02"
    jnpz = np.load(jdir / "factorized_rate.npz")
    tnpz = np.load(tdir / "factorized_rate.npz")
    assert jnpz.files == tnpz.files
    for k in jnpz.files:
        # the parameters' tolerance of test_slice_params_match_jax
        np.testing.assert_allclose(tnpz[k], jnpz[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # each side's loader reads the other's file
    for path in (jdir, tdir):
        a = jsave.load_hub_npz(path / "factorized_rate.npz")
        b = tsave.load_hub_npz(path / "factorized_rate.npz")
        assert a[0].keys() == b[0].keys()
        for x, y in zip((*a[0].values(), a[1], a[2]),
                        (*b[0].values(), b[1], b[2])):
            np.testing.assert_array_equal(x, y)
    pt = torch.load(tdir / "factorized_rate.pt")
    assert sorted(pt) == sorted(tnpz.files)
    # and the port's published-weights loader reads the .pt
    from lossyless_tpu_torch.hub.load_reference import load_factorized_rate

    ebp, scaling, _ = load_factorized_rate(tdir / "factorized_rate.pt")
    np.testing.assert_array_equal(scaling, tnpz["scaling"])
    np.testing.assert_array_equal(ebp["matrix4"],
                                  tnpz["entropy_bottleneck._matrix4"])
