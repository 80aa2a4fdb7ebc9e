"""Port hyperprior rate (slice 3) against the JAX package.

The same numpy-seeded inputs, params and noise draws go through the JAX
functions and their counterparts in the port: the Gaussian conditional
(tables under both arithmetics, likelihood, quantize, indexes), the
per-message-index rANS API, `HyperpriorCoder` against the self-contained
fixture `tests/golden/streams_hyper.npz`, `HRateHyperprior` values and
gradients, a tiny `clip_bottleneck_pretrain` compressor trained for 3
steps, and the communication stage's `n_bits`. The JAX Pallas kernels run
in interpret mode; the port's kernels take their plain versions on CPU
tensors.

Tolerances, with their reasons:
* integer tables, symbols, indexes and streams: exact (the wire format);
* likelihoods rtol 1e-5 / atol 1e-9 (XLA's and torch's fp32 erfc differ
  in the last bits; 1e-9 is the likelihood floor);
* the rate estimator's values rtol 1e-5 and gradients rtol 1e-4
  (tests/test_pallas_eb.py's), with atol 1e-5 of the largest gradient
  entry (the batch sums cancel; tests/test_torch_training.py);
* the 3-step slice at tests/test_torch_training.py's tolerances for
  clip_hub (fp32 logs rtol 1e-5, parameters rtol 1e-4 / atol 1e-5; bf16
  5e-2 on what the tower's output sets), except that in bf16 up to 10%
  of a parameter's entries (one in a small one) may take an Adam step the
  other way (their
  gradients are near 0 at bf16 precision), bounded by the steps' travel.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.coding import gaussian_conditional as jgc
from lossyless_tpu.coding.rans import RansCodec as JRans
from lossyless_tpu.compressors import rates as jrates
from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.coding import gaussian_conditional as tgc
from lossyless_tpu_torch.coding import rans as trans
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.nn import mlp as tmlp
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train import metrics as tmetrics
from lossyless_tpu_torch.train import state as tstate
from tests import torch_threads  # noqa: F401  (one pool a worker)

GOLDEN = Path(__file__).parent / "golden"

# ---------------------------------------------------------------------------
# Gaussian conditional
# ---------------------------------------------------------------------------

SCALE_TABLES = {
    "default": lambda m: m.default_scale_table(),
    "compressai": lambda m: m.compressai_scale_table(),
    "short": lambda m: m.default_scale_table(0.5, 40.0, 16),
}


@pytest.mark.parametrize("arithmetic", ["float64", "compressai"])
@pytest.mark.parametrize("table", list(SCALE_TABLES))
def test_cdf_tables_equal_jax(table, arithmetic):
    js, ts = SCALE_TABLES[table](jgc), SCALE_TABLES[table](tgc)
    np.testing.assert_array_equal(ts, js)
    j = jgc.build_cdf_tables(js, arithmetic=arithmetic)
    t = tgc.build_cdf_tables(ts, arithmetic=arithmetic)
    np.testing.assert_array_equal(t.quantized_cdf, j.quantized_cdf)
    np.testing.assert_array_equal(t.cdf_length, j.cdf_length)
    np.testing.assert_array_equal(t.offset, j.offset)
    with pytest.raises(ValueError, match="arithmetic"):
        tgc.build_cdf_tables(ts, arithmetic="float16")


def _gc_inputs(seed=0, shape=(9, 13)):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=shape) * 6).astype(np.float32)
    scales = np.exp(rng.normal(size=shape) * 1.5).astype(np.float32)
    means = rng.normal(size=shape).astype(np.float32)
    noise = rng.uniform(-0.5, 0.5, size=shape).astype(np.float32)
    return z, scales, means, noise


@pytest.mark.parametrize("with_means", [True, False])
def test_likelihood_quantize_indexes_equal_jax(with_means):
    z, scales, means, noise = _gc_inputs(1)
    m = means if with_means else None
    tm = torch.from_numpy(means) if with_means else None
    jm = jnp.asarray(means) if with_means else None
    want = jgc.likelihood(jnp.asarray(z), jnp.asarray(scales), jm)
    got = tgc.likelihood(torch.from_numpy(z), torch.from_numpy(scales), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)
    for mode in ("dequantize", "symbols"):
        w = np.asarray(jgc.quantize(jnp.asarray(z), mode, jm))
        g = tgc.quantize(torch.from_numpy(z), mode, tm).numpy()
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    g = tgc.quantize(torch.from_numpy(z), "noise", tm,
                     torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(g, z + noise)
    for training in (True, False):
        tz, tl = tgc.forward(torch.from_numpy(z), torch.from_numpy(scales),
                             tm, training=training,
                             noise=torch.from_numpy(noise))
        wz = z + noise if training else np.asarray(
            jgc.quantize(jnp.asarray(z), "dequantize", jm))
        np.testing.assert_array_equal(tz.numpy(), wz)
        wl = np.maximum(np.asarray(jgc.likelihood(jnp.asarray(wz),
                                                  jnp.asarray(scales), jm)),
                        1e-9)
        np.testing.assert_allclose(tl.numpy(), wl, rtol=1e-5, atol=1e-9)
    st = jgc.default_scale_table()
    s = np.concatenate([scales.ravel(), st, [0.01, 300.0, st[0], st[-1]]])
    np.testing.assert_array_equal(
        tgc.build_indexes(torch.from_numpy(s.astype(np.float32)), st).numpy(),
        np.asarray(jgc.build_indexes(jnp.asarray(s, jnp.float32), st)))
    np.testing.assert_array_equal(
        trates._host_build_indexes(s, st), jrates._host_build_indexes(s, st))


def test_gaussian_pmf_sums_to_one():
    grid = torch.arange(-40, 41, dtype=torch.float32)[:, None]
    lik = tgc.likelihood(grid, torch.full((1,), 2.5), torch.full((1,), 0.3))
    assert abs(float(lik.sum()) - 1.0) < 1e-4


# ---------------------------------------------------------------------------
# rANS with an index row per message
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,m", [(5, 17), (1, 1), (33, 64), (0, 4)])
def test_varidx_streams_equal_jax(batch, m):
    t = tgc.build_cdf_tables(tgc.default_scale_table())
    rng = np.random.default_rng(batch * 100 + m)
    idx = rng.integers(0, len(t.cdf_length), (batch, m)).astype(np.int32)
    # mostly in range, a few escapes past both ends of the tables
    sym = (rng.normal(size=(batch, m)) * 6).round().astype(np.int32)
    sym[rng.random((batch, m)) < 0.05] = 4000
    sym[rng.random((batch, m)) < 0.05] = -4000
    jc = JRans(t.quantized_cdf, t.cdf_length, t.offset)
    tc = trans.RansCodec(t.quantized_cdf, t.cdf_length, t.offset)
    got = tc.encode_batch_varidx(sym, idx)
    assert got == jc.encode_batch_varidx(sym, idx)
    assert len(got) == batch
    np.testing.assert_array_equal(tc.decode_batch_varidx(got, idx), sym)
    np.testing.assert_array_equal(jc.decode_batch_varidx(got, idx), sym)
    for i in range(batch):   # the pure-Python codec writes the same bytes
        assert got[i] == trans._py_encode(sym[i], idx[i], tc.cdfs,
                                          tc.cdf_lengths, tc.offsets)


def test_varidx_rejects_bad_input():
    t = tgc.build_cdf_tables(tgc.default_scale_table())
    tc = trans.RansCodec(t.quantized_cdf, t.cdf_length, t.offset)
    with pytest.raises(ValueError, match="must be equal"):
        tc.encode_batch_varidx(np.zeros((2, 3)), np.zeros((2, 4)))
    with pytest.raises(IndexError, match="out of range"):
        tc.encode_batch_varidx(np.zeros((1, 2)), np.full((1, 2), 64))
    with pytest.raises(ValueError, match="streams but"):
        tc.decode_batch_varidx([b"", b""], np.zeros((3, 2)))
    s = tc.encode_batch_varidx(np.ones((2, 5)), np.ones((2, 5)))
    with pytest.raises(ValueError, match="corrupt"):
        tc.decode_batch_varidx([s[0][:4], s[1]], np.ones((2, 5)))


# ---------------------------------------------------------------------------
# HyperpriorCoder against the golden fixture
# ---------------------------------------------------------------------------


def _load_fixture():
    from tests.test_golden_streams import _fixture_variables, _load_grouped

    f, streams = _load_grouped("streams_hyper.npz")
    return f, streams, _fixture_variables(f)


def _port_module(params, z_dim=16, side=10, **kw):
    m = trates.HRateHyperprior(z_dim, trates.RateConfig(
        mode="H_hyper", side_z_dim=side, **kw))
    m.load_state_dict(tmlp.params_from_flax(params))
    return m


def test_hyperprior_coder_reproduces_golden_streams():
    f, golden, variables = _load_fixture()
    coder = trates.HyperpriorCoder(_port_module(variables["params"]))
    streams = coder.compress(f["z"])
    assert len(streams) == len(golden) == 2
    for grp, ggrp in zip(streams, golden):
        assert [bytes(s) for s in grp] == [bytes(s) for s in ggrp]
    z_hat = coder.decompress(golden)
    np.testing.assert_array_equal(z_hat, f["z_hat"])
    # the receiver's host dequantize of the sender's symbols is the decode
    np.testing.assert_array_equal(
        coder.dequantize(*coder.encode_symbols(f["z"])), z_hat)


def test_hyperprior_coder_matches_jax_coder_and_eval_z_hat():
    """Fresh seeded params (moved off their init): the port's streams are
    JAX's, and the decode is the eval-mode forward's z_hat."""
    z = np.random.default_rng(0).normal(0, 3, (32, 24)).astype(np.float32)
    jm = jrates.HRateHyperprior(24, jrates.RateConfig(mode="H_hyper",
                                                      side_z_dim=10))
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(z), None,
                training=True, rng=jax.random.key(1))
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), v["params"])
    want = jrates.HyperpriorCoder(jm, params).compress(z)
    tm = _port_module(params, 24)
    coder = trates.HyperpriorCoder(tm)
    got = coder.compress(z)
    assert got == want
    with torch.no_grad():
        z_hat, _, _ = tm(torch.from_numpy(z), None, training=False)
    np.testing.assert_allclose(coder.decompress(got), z_hat.numpy(),
                               atol=1e-4)


def test_factorized_coder_matches_jax():
    C, B = 12, 20
    z = np.random.default_rng(3).normal(0, 2, (B, C)).astype(np.float32)
    cfg = jrates.RateConfig(eb_filters=(3, 3, 3))
    jm = jrates.HRateFactorizedPrior(C, cfg)
    v = jm.init({"params": jax.random.key(4)}, jnp.asarray(z), None,
                training=True, rng=jax.random.key(5))
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32), v["params"])
    jc = jrates.FactorizedCoder(params)
    tc = trates.FactorizedCoder(params)
    assert tc.compress(z) == jc.compress(z)
    np.testing.assert_array_equal(tc.decompress(jc.compress(z)),
                                  jc.decompress(jc.compress(z)))
    tm = trates.HRateFactorizedPrior(C, trates.RateConfig())
    tm.load_state_dict(tmlp.params_from_flax(params))
    assert trates.FactorizedCoder.from_module(tm).compress(z) == \
        jc.compress(z)


def test_host_mlp_forward_counts_only_dense_layers():
    rng = np.random.default_rng(7)
    params = {f"Dense_{i}": {"kernel": rng.normal(size=(4, 4)).astype(
        np.float32), "bias": rng.normal(size=4).astype(np.float32)}
        for i in range(3)}
    x = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_array_equal(trates._host_mlp_forward(params, x),
                                  jrates._host_mlp_forward(params, x))
    bad = dict(params, BatchNorm_0={"scale": np.ones(4), "bias": np.zeros(4)})
    with pytest.raises(ValueError, match="Dense_\\* layers only"):
        trates._host_mlp_forward(bad, x)
    gap = {k: v for k, v in params.items() if k != "Dense_1"}
    with pytest.raises(ValueError, match="Dense_0..Dense_1"):
        trates._host_mlp_forward(gap, x)


# ---------------------------------------------------------------------------
# HRateHyperprior: values and gradients with both noise draws
# ---------------------------------------------------------------------------


def _hyper_setup(use_pallas, z_dim=20, side=10, B=16):
    z = (np.random.default_rng(8).normal(size=(B, z_dim)) * 3).astype(
        np.float32)
    cfg = dict(mode="H_hyper", side_z_dim=side, eb_use_pallas=use_pallas)
    jm = jrates.HRateHyperprior(z_dim, jrates.RateConfig(**cfg))
    v = jm.init({"params": jax.random.key(1)}, jnp.asarray(z), None,
                training=True, rng=jax.random.key(2))
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), v["params"])
    tm = trates.HRateHyperprior(z_dim, trates.RateConfig(**cfg))
    tm.load_state_dict(tmlp.params_from_flax(params))
    return z, jm, params, tm


def _jax_pair_noise(key, B, side, z_dim):
    """The rate's two draws as HRateHyperprior takes them (rates.py:229)."""
    r1, r2 = jax.random.split(key)
    return tuple(np.asarray(jax.random.uniform(r, s, jnp.float32, -0.5, 0.5))
                 for r, s in ((r1, (B, side)), (r2, (B, z_dim))))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_hyperprior_rate_matches_jax(training, use_pallas):
    z, jm, params, tm = _hyper_setup(use_pallas)
    key = jax.random.key(3)
    w = np.random.default_rng(10).normal(size=len(z)).astype(np.float32)

    def jloss(p, zz):
        z_hat, rates, logs = jm.apply({"params": p}, zz, None,
                                      training=training, rng=key)
        return jnp.sum(rates * w) + jnp.sum(z_hat), (z_hat, rates, logs)

    (_, (jz_hat, jr, jlogs)), (jg, jgz) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(z))
    noise = tuple(map(torch.from_numpy,
                      _jax_pair_noise(key, len(z), 10, z.shape[1])))
    tz = torch.from_numpy(z).requires_grad_()
    tz_hat, tr, tlogs = tm(tz, None, training=training, noise=noise)
    ((tr * torch.from_numpy(w)).sum() + tz_hat.sum()).backward()

    np.testing.assert_allclose(tz_hat.detach().numpy(), np.asarray(jz_hat),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr),
                               rtol=1e-5)
    for k in ("H_q_ZlS", "H_q_Z", "H_q_S"):
        assert float(tlogs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5)
    want = tmlp.params_from_flax(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n, g in want.items():
        g = g.numpy()
        # the medians reach z_hat only when it is dequantized
        tg = torch.zeros(g.shape) if got[n] is None else got[n]
        np.testing.assert_allclose(tg.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=n)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgz), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jgz)).max())


def test_hyperprior_detached_rate_is_one_evaluation():
    """is_endToEnd=False: the rates see a detached z, z_hat stays live,
    and both equal the undetached forward's."""
    _, _, _, tm = _hyper_setup(False)
    z = torch.randn(5, 20, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.Generator().manual_seed(1)
    noise = (torch.rand(5, 10, generator=g) - .5,
             torch.rand(5, 20, generator=g) - .5)
    z_hat, rates, _ = tm(z, None, training=True, noise=noise,
                         detach_rate=True)
    (gz,) = torch.autograd.grad(rates.sum(), z, allow_unused=True)
    assert gz is None
    (gz,) = torch.autograd.grad(z_hat.sum(), z)
    assert torch.allclose(gz, torch.ones_like(gz))
    ref_hat, ref_rates, _ = tm(z, None, training=True, noise=noise)
    assert torch.equal(z_hat, ref_hat) and torch.equal(rates, ref_rates)
    # the generator path draws the side noise, then the main noise
    a = tm(z, None, training=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], ref_hat)


def test_hyperprior_sizes_and_modes():
    m = trates.make_rate_estimator(512, trates.RateConfig(mode="H_hyper"))
    assert m.side_z_dim == 102
    assert m.side_encoder.Dense_0.kernel.shape == (512, 512)
    assert m.z_encoder.Dense_2.kernel.shape == (512, 1024)
    assert trates.make_rate_estimator(
        40, trates.RateConfig(mode="H_hyper")).side_z_dim == 10
    small = trates.make_rate_estimator(
        16, trates.RateConfig(mode="H_hyper", is_pred_mean=False))
    assert small.z_encoder.Dense_0.kernel.shape == (10, 256)
    assert small.z_encoder.Dense_2.kernel.shape == (256, 16)
    spatial = trates.make_rate_estimator(
        64, trates.RateConfig(mode="H_spatial", n_channels=4))
    assert isinstance(spatial, trates.HRateHyperpriorSpatial)
    assert spatial.side_dim == 4 and spatial.inner.side_z_dim == 10
    with pytest.raises(ValueError, match="square"):
        trates.make_rate_estimator(
            8, trates.RateConfig(mode="H_spatial", n_channels=4))
    assert isinstance(trates.make_rate_estimator(
        8, trates.RateConfig(mode="MI")), trates.MIRate)
    assert isinstance(trates.make_rate_estimator(
        8, trates.RateConfig(mode="lossless")), trates.Lossless)


# ---------------------------------------------------------------------------
# The slice: a tiny clip_bottleneck_pretrain compressor, 3 train steps
# ---------------------------------------------------------------------------

OVERRIDES = ["rate.eb_use_pallas=True", "encoder.arch_kwargs.attn_impl=pallas",
             "encoder.z_dim=16", "encoder.arch_kwargs.width=64",
             "encoder.arch_kwargs.layers=2", "encoder.arch_kwargs.heads=2",
             "data_feat.batch_size=4"]
IN_SHAPE, B, STEPS = (32, 32, 3), 4, 3


def _configs(dtype, tmp=None):
    ov = OVERRIDES + [f"encoder.arch_kwargs.dtype={dtype}"]
    if tmp is not None:
        ov.append(f"out_dir={tmp}")
    j = jconfig.apply_precision(jconfig.apply_overrides(
        jconfig.preset("clip_bottleneck_pretrain"), ov))
    t = tconfig.apply_precision(tconfig.apply_overrides(
        tconfig.preset("clip_bottleneck_pretrain"), ov))
    j.in_shape = t.in_shape = IN_SHAPE
    return j, t


def _batches(n=STEPS, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, *IN_SHAPE)).astype(np.float32),
             np.zeros(B, np.int32), np.zeros(B, np.float32))
            for _ in range(n)]


def _jax_state(jcfg, batch):
    model = JLC(jcfg.compressor_config())
    opts = [jstate.bind_schedule_steps(o, STEPS, STEPS)
            for o in (jcfg.optimizer_feat, jcfg.optimizer_online,
                      jcfg.optimizer_coder)]
    state = jstate.TrainState.create(
        model, tuple(map(jnp.asarray, batch)),
        jax.random.key(jcfg.trainer.seed), main=opts[0], online=opts[1],
        coder=opts[2], frozen_paths=tuple(jcfg.frozen))
    return model, state


def _jax_run(jcfg, batches):
    _, state = _jax_state(jcfg, batches[0])
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
    side = state.model.rate_estimator.side_z_dim
    logs = []
    for step, (x, y, aux) in enumerate(batches):
        # the rate's key of step `step` (compressor.py:185), split in two
        key = jax.random.split(jax.random.key(step), 4)[1]
        noise = tuple(map(torch.from_numpy, _jax_pair_noise(
            key, B, side, tcfg.encoder.z_dim)))
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
        assert {"H_q_ZlS", "H_q_S", "H_q_Z"} <= set(t)
        for k in j:
            if dtype == "float32":
                assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-6), \
                    (step, k)
            else:
                assert t[k] == pytest.approx(j[k], rel=5e-2, abs=5e-2), \
                    (step, k)


def test_slice_params_match_jax(slice_runs):
    dtype, params0, jparams, _, state, _ = slice_runs
    want = tcomp.compressor_params_from_flax(jparams)
    start = tcomp.compressor_params_from_flax(params0)
    got = state.model.state_dict()
    assert set(got) == set(want)
    assert any(".side_encoder.Dense_2." in n for n in got)
    labels = {n: tstate.param_label(n, ("p_ZlX",)) for n in want}
    for name, w in want.items():
        g = got[name].numpy()
        if labels[name] == "frozen":
            np.testing.assert_array_equal(g, start[name].numpy(), name)
            continue
        w = w.numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        # bf16: an entry whose gradient is near 0 at bf16 precision (a ReLU
        # at its kink for one side's tower output, an affine entry whose
        # distortion gradient is 0 analytically, next to a rate gradient
        # scaled by the annealed beta of 5e-7) can take Adam's normalized
        # step the other way. At most 10% of a tensor's entries (one in a
        # small tensor) may leave the clip_hub tolerance, none by more than
        # the 3 steps' travel both ways (2 x 3 x lr). The fp32 run above
        # holds every entry.
        bad = ~np.isclose(g, w, rtol=5e-2, atol=5e-2 * np.abs(w).max())
        assert bad.sum() <= max(1, 0.1 * bad.size), (name, bad.sum())
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * STEPS * 1e-3,
                                   err_msg=name)


def test_preset_trains_through_run_featurizer(tmp_path):
    """The entry point on the CPU: 3 steps with noise from the step's
    generator, the logs through the CSV logger."""
    _, tcfg = _configs("float32", tmp_path)
    tcfg.in_shape = None
    tcfg.trainer.log_every = 1
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches()]
    state = trun.run_featurizer(tcfg, batches, device="cpu",
                                log=lambda _: None)
    assert state.step == STEPS
    rows = (Path(tcfg.stage_dir) / "train_featurizer.csv").read_text() \
        .splitlines()
    assert len(rows) == 1 + STEPS and "train/feat/H_q_ZlS" in rows[0]
    assert "clip_bottleneck_pretrain" in tconfig.available_presets()


class _Dataset:
    """The JAX stage's measurement-set interface over fixed batches."""

    def __init__(self, batches):
        self._b = batches

    def __len__(self):
        return sum(len(b[0]) for b in self._b)

    def batches(self, bs, n_epochs=1, seed=0):
        x = np.concatenate([b[0] for b in self._b])
        for i in range(0, len(x) - bs + 1, bs):
            yield x[i:i + bs], np.zeros(bs, np.int32), np.zeros(bs)


@pytest.mark.parametrize("mode", ["H_hyper", "H_factorized"])
def test_run_communication_matches_jax_n_bits(mode, tmp_path):
    """The same initial weights on both sides code the same images to the
    same number of bits; results CSV and sentinel in the stage dir."""
    jcfg, tcfg = _configs("float32", tmp_path / "torch")
    jcfg.out_dir = str(tmp_path / "jax")
    if mode == "H_factorized":
        jcfg.rate = dataclasses.replace(jcfg.rate, mode=mode)
        tcfg.rate = dataclasses.replace(tcfg.rate, mode=mode)
    batches = _batches(2, seed=11)
    jcfg.data_feat.val_batch_size = B
    model, jstate_ = _jax_state(jcfg, batches[0])
    want = jrun.run_communication(jcfg, model, jstate_, _Dataset(batches))
    state = trun.build_state(tcfg, STEPS, STEPS, device="cpu")
    state.model.load_state_dict(tcomp.compressor_params_from_flax(
        jax.tree.map(np.asarray, jstate_.params)))
    got = trun.run_communication(tcfg, state, [tuple(map(torch.from_numpy, b))
                                               for b in batches],
                                 device="cpu")
    assert set(got) == set(want)
    assert got["test/comm/n_bits"] == want["test/comm/n_bits"]
    assert got["test/comm/bpp"] == pytest.approx(
        got["test/comm/n_bits"] / (32 * 32))
    stage = Path(tcfg.stage_dir)
    assert tckpt.is_stage_done(stage, "communication")
    assert tmetrics.read_results_csv(stage / "results_communication.csv") \
        == pytest.approx(got)


# ---------------------------------------------------------------------------
# The MLP family and the layers it needs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("norm", ["identity", "batchnorm", "layernorm"])
def test_mlp_matches_flax(norm, training):
    """Forward values (and BatchNorm's running statistics after a training
    call) against flax's MLP with the same params, fp32 rtol 1e-5."""
    from lossyless_tpu.nn import mlp as jmlp

    x = np.random.default_rng(12).normal(size=(6, 3, 4)).astype(np.float32)
    jm = jmlp.MLP(out_dim=5, hid_dim=16, n_hid_layers=2, norm_layer=norm)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    rng = np.random.default_rng(13)
    v = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32), jax.tree.map(np.asarray, v))
    if "batch_stats" in v:      # a moved, positive running variance
        v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])
    out = jm.apply(v, jnp.asarray(x), training=training,
                   mutable=["batch_stats"] if training else False)
    want, new_vars = out if training else (out, v)
    tm = tmlp.MLP(12, 5, hid_dim=16, n_hid_layers=2, norm_layer=norm)
    tm.load_state_dict(_merged(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if norm == "batchnorm" and training:
        for i in range(2):
            bn = getattr(tm, f"BatchNorm_{i}")
            stats = new_vars["batch_stats"][f"BatchNorm_{i}"]
            np.testing.assert_allclose(bn.mean.numpy(), stats["mean"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(bn.var.numpy(), stats["var"],
                                       rtol=1e-5, atol=1e-6)
    assert ("Dense_0.bias" in tm.state_dict()) == (norm == "identity")


def _merged(v):
    """flax params and batch_stats as one state dict of the port's MLP."""
    out = tmlp.params_from_flax(v["params"])
    out.update(tmlp.params_from_flax(v.get("batch_stats", {})))
    return out


def test_flatten_modules_and_activations_match_flax():
    from lossyless_tpu.nn import layers as jlayers
    from lossyless_tpu.nn import mlp as jmlp
    from lossyless_tpu_torch.nn import layers as tlayers

    x = np.random.default_rng(14).normal(size=(3, 2, 5)).astype(np.float32)
    for jcls, tcls in ((jmlp.FlattenMLP, tmlp.FlattenMLP),
                       (jmlp.FlattenLinear, tmlp.FlattenLinear)):
        jm = jcls(out_shape=(2, 3))
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(1),
                                             jnp.asarray(x)))
        tm = tcls((2, 5), (2, 3))
        tm.load_state_dict(tmlp.params_from_flax(v["params"]))
        got = tm(torch.from_numpy(x))
        assert got.shape == (3, 2, 3)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(jm.apply(v, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
    assert torch.equal(tmlp.Identity()(torch.ones(2)), torch.ones(2))
    for name in ("relu", "gelu", "silu", "swish", "tanh", "elu",
                 "leakyrelu", "quickgelu"):
        np.testing.assert_allclose(
            tlayers.get_activation(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jlayers.get_activation(name)()(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6, err_msg=name)
    # GDN is a factory of modules, as JAX's (tests/test_torch_balle_spatial.py
    # holds it to flax)
    for inverse in (False, True):
        gdn = tlayers.get_activation("gdn", inverse=inverse)(3)
        assert isinstance(gdn, tlayers.GDN) and gdn.inverse == inverse
        assert isinstance(jlayers.get_activation("gdn", inverse)(),
                          jlayers.GDN)
    # kaiming uniform: U(-sqrt(6 / fan_in), +sqrt(6 / fan_in))
    k = tlayers.KAIMING_UNIFORM((600, 50), torch.Generator().manual_seed(0))
    assert k.abs().max() <= (6 / 600) ** 0.5
    assert k.std().item() == pytest.approx((2 / 600) ** 0.5, rel=0.05)
