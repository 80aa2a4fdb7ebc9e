"""Data-parallel training on the CPU: one spawned gloo group of 2 ranks
(`tests/torch_dist_worker.py`) against the single-process port and JAX's
8-device sharded step.

The group serves every check: the contrastive loss (global negatives
through the differentiable all-gather) and its gradients, BatchNorm's
statistics over the global batch, one `train_step` of the MLP compressor
of tests/test_sharding.py (with a BatchNorm encoder, so the step's
statistics and gradients both cross the ranks), the global draws, and
`main` of `banana_viz_VIC` under `trainer.n_devices=2` (the group of
torchrun's path; `pipeline.run._spawn_ranks` is tested in
test_torch_mesh.py). Gradients of a rank's rows are of its local mean
loss, the global objective the mean of the ranks' (equal shards), so a
rank's row gradients over the world size are the single-process
gradients of those rows.

Tolerances are JAX's own mesh tests': the loss rtol / atol 2e-5
(tests/test_sharding.py), parameters after a step rtol 1e-4 / atol 1e-6
(the same), pipeline metrics rtol 2e-4 / atol 2e-5 and `n_bits` rtol 1e-3
(tests/test_pipeline_mesh.py); gradients rtol 1e-4 / atol 1e-6 (summed
in another order over the ranks). Against JAX's step the parameters are
held at test_torch_training.py's atol 1e-5 (1% of the step's lr): Adam's
first update is lr * g / (|g| + eps), and a gradient within roundoff of
eps moves it by up to that much between any two fp32 evaluations.
"""

import dataclasses
import queue as queue_lib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from lossyless_tpu.compressors import compressor as jcomp
from lossyless_tpu.compressors.distortions import (
    ContrastiveDistortion as JContrastive)
from lossyless_tpu.compressors.distortions import (
    DistortionConfig as JDistortionConfig)
from lossyless_tpu.compressors.rates import RateConfig as JRateConfig
from lossyless_tpu.core.mesh import make_mesh as jmake_mesh
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors.distortions import (
    ContrastiveDistortion, DistortionConfig)
from lossyless_tpu_torch.compressors.rates import RateConfig, uniform_noise
from lossyless_tpu_torch.core import mesh
from lossyless_tpu_torch.data.banana import device_sample_batch
from lossyless_tpu_torch.nn.layers import BatchNorm
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline.run import main as tmain
from lossyless_tpu_torch.train.state import OptimConfig, TrainState, \
    train_step
from tests import torch_dist_worker
from tests import torch_threads  # noqa: F401  (one pool a worker)

WORLD = 2
LOSS = dict(rtol=2e-5, atol=2e-5)
PARAMS = dict(rtol=1e-4, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
CONTRASTIVE = [
    # tests/test_sharding.py's, then the presets' projector and trained
    # temperature with the effective batch size
    DistortionConfig(mode="contrastive", is_project=False,
                     is_train_temperature=False, temperature=0.1),
    DistortionConfig(mode="contrastive", project_dim=8,
                     effective_batch_size=64)]
BANANA = ["data_feat.n_epochs=1", "data_feat.kwargs.length=2048",
          "data_feat.batch_size=512", "data_feat.val_batch_size=512",
          "predictor.n_epochs=1", "encoder.arch_kwargs.hid_dim=32",
          "distortion.arch_kwargs.hid_dim=32"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _step_inputs():
    """tests/test_sharding.py's compressor and batch, its encoder with a
    BatchNorm; JAX's initial variables and its step's noise."""
    kw = dict(encoder=dict(arch="mlp", z_dim=4,
                           arch_kwargs=dict(hid_dim=16,
                                            norm_layer="batchnorm")),
              rate=dict(mode="H_factorized"),
              distortion=dict(mode="direct", data_mode="distribution",
                              is_classification=False,
                              arch_kwargs=dict(hid_dim=16)),
              online=dict(is_online=False),
              loss=dict(beta=0.1, beta_anneal="constant"))

    def build(m, rate_cls, dist_cls):
        return m.CompressorConfig(
            encoder=m.EncoderConfig(**kw["encoder"]),
            rate=rate_cls(**kw["rate"]), distortion=dist_cls(**kw[
                "distortion"]), online=m.OnlineEvalConfig(**kw["online"]),
            loss=m.LossConfig(**kw["loss"]), in_shape=(2,), target_shape=1,
            aux_shape=2)

    jcfg = build(jcomp, JRateConfig, JDistortionConfig)
    tcfg = build(tcomp, RateConfig, DistortionConfig)
    rng = np.random.default_rng(1)
    batch = (rng.normal(size=(16, 2)).astype(np.float32),
             rng.normal(size=(16, 1)).astype(np.float32),
             rng.normal(size=(16, 2)).astype(np.float32))
    return jcfg, tcfg, batch


def _jax_steps(jcfg, batch):
    """JAX's step on one device and on the 8-device mesh (key 1), its
    initial variables and the step's rate noise."""
    model = jcomp.LearnableCompressor(jcfg)
    out = {}
    for name in ("single", "sharded"):
        state = jstate.TrainState.create(
            model, batch, jax.random.key(0),
            main=jstate.OptimConfig(lr=1e-3))
        out["params0"] = jax.tree.map(np.asarray, state.params)
        out["stats0"] = jax.tree.map(np.asarray, state.batch_stats)
        b = tuple(map(jnp.asarray, batch))
        if name == "sharded":
            mesh8 = jmake_mesh(8)
            state = jax.device_put(state, NamedSharding(mesh8, P()))
            b = jax.tree.map(lambda x: jax.device_put(
                x, NamedSharding(mesh8, P("data"))), b)
        s, logs = jstate.train_step(state, b, jax.random.key(1))
        out[name] = (jax.tree.map(np.asarray, s.params),
                     jax.tree.map(np.asarray, s.batch_stats),
                     {k: float(v) for k, v in logs.items()})
    key = jax.random.split(jax.random.key(1), 4)[1]
    out["noise"] = np.asarray(jax.random.uniform(key, (16, 4), jnp.float32,
                                                 -0.5, 0.5))
    return out


def _spawn(payload: dict) -> list[dict]:
    """Run the worker's checks in one gloo group of WORLD ranks; their
    results in rank order (read while the ranks run: a result may be
    larger than a pipe holds). The ranks are killed, and the call fails,
    if the group has not ended within `torch_dist_worker.SPAWN_TIMEOUT_S`."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = mp.start_processes(torch_dist_worker.run,
                               args=(WORLD, mesh.free_port(), payload, q),
                               nprocs=WORLD, join=False,
                               start_method="spawn")
    results = []
    with torch_dist_worker.bounded():
        try:
            while len(results) < WORLD:
                try:
                    results.append(q.get(timeout=1))
                except queue_lib.Empty:
                    procs.join(timeout=0)      # raises if a rank failed
            while not procs.join(timeout=1):
                pass
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
    return sorted(results, key=lambda r: r["rank"])


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every check's inputs, the group's results, and the references."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(32, 16)).astype(np.float32)
    z_pos = rng.normal(size=(32, 16)).astype(np.float32)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.scale.copy_(_t(rng.normal(1, 0.2, 6).astype(np.float32)))
        bn.bias.copy_(_t(rng.normal(0, 0.2, 6).astype(np.float32)))
    x_bn = rng.normal(2, 3, size=(16, 6, 4, 4)).astype(np.float32)
    c_bn = rng.normal(size=(16, 6, 4, 4)).astype(np.float32)
    jcfg, tcfg, batch = _step_inputs()
    jax_out = _jax_steps(jcfg, batch)
    state0 = tcomp.compressor_params_from_flax(jax_out["params0"],
                                               jax_out["stats0"])
    tmp = tmp_path_factory.mktemp("dp")
    cfg = tconfig.apply_overrides(
        tconfig.preset("banana_viz_VIC"),
        BANANA + [f"out_dir={tmp}/two/out", f"ckpt_dir={tmp}/two/ck",
                  "trainer.n_devices=2"])
    payload = {
        "contrastive": dict(z=_t(z), z_pos=_t(z_pos), z_dim=16,
                            cfgs=CONTRASTIVE),
        "batchnorm": dict(x=_t(x_bn), c=_t(c_bn), state=bn.state_dict()),
        "step": dict(cfg=tcfg, state=state0,
                     batch=tuple(map(_t, batch)),
                     noise=_t(jax_out["noise"])),
        "draws": dict(rows=4),
        "main": dict(cfg=cfg)}
    ranks = _spawn(payload)
    one = tconfig.apply_overrides(
        tconfig.preset("banana_viz_VIC"),
        BANANA + [f"out_dir={tmp}/one/out", f"ckpt_dir={tmp}/one/ck"])
    return dict(payload=payload, ranks=ranks, jax=jax_out, tcfg=tcfg,
                state0=state0, batch=batch, bn=bn, tmp=tmp,
                main1=tmain(one, device="cpu"))


def _cat(ranks, check, key, i=None):
    parts = [r[check][i][key] if i is not None else r[check][key]
             for r in ranks]
    return np.concatenate(parts)


@pytest.mark.parametrize("i", range(len(CONTRASTIVE)))
def test_contrastive_loss_and_grads_match_single_process(group, i):
    p = group["payload"]["contrastive"]
    model = ContrastiveDistortion(16, CONTRASTIVE[i],
                                  torch.Generator().manual_seed(0))
    z = p["z"].clone().requires_grad_()
    zp = p["z_pos"].clone().requires_grad_()
    d, logs = model(z, zp, training=True)
    loss = d.mean()
    loss.backward()
    ranks = group["ranks"]
    for r in ranks:
        got = r["contrastive"][i]
        np.testing.assert_allclose(float(got["logs"]["loss"]), float(loss),
                                   **LOSS)
        np.testing.assert_allclose(float(got["logs"]["I_q_zm"]),
                                   float(logs["I_q_zm"]), **LOSS)
        assert got["n_negatives"] == logs["n_negatives"] == 63.0
        for n, q in model.named_parameters():
            np.testing.assert_allclose(got["params"][n], q.grad.numpy(),
                                       err_msg=n, **GRADS)
    np.testing.assert_allclose(_cat(ranks, "contrastive", "dz", i) / WORLD,
                               z.grad.numpy(), **GRADS)
    np.testing.assert_allclose(
        _cat(ranks, "contrastive", "dz_pos", i) / WORLD, zp.grad.numpy(),
        **GRADS)


def test_contrastive_loss_matches_jax_sharded(group):
    """tests/test_sharding.py's check: the global InfoNCE on the 8-device
    mesh equals the port's over 2 ranks."""
    p = group["payload"]["contrastive"]
    jcfg = JDistortionConfig(mode="contrastive", is_project=False,
                             is_train_temperature=False, temperature=0.1)
    model = JContrastive(jcfg)
    z, zp = jnp.asarray(p["z"].numpy()), jnp.asarray(p["z_pos"].numpy())
    variables = model.init(jax.random.key(0), z, zp)
    sh = NamedSharding(jmake_mesh(8), P("data"))
    d, _ = jax.jit(lambda a, b: model.apply(variables, a, b))(
        jax.device_put(z, sh), jax.device_put(zp, sh))
    for r in group["ranks"]:
        np.testing.assert_allclose(float(r["contrastive"][0]["logs"]["loss"]),
                                   float(jnp.mean(d)), **LOSS)


def test_batchnorm_statistics_span_the_global_batch(group):
    p, bn = group["payload"]["batchnorm"], group["bn"]
    x = p["x"].clone().requires_grad_()
    y = bn(x, training=True)
    ((y * p["c"]).sum() / len(x)).backward()
    ranks = group["ranks"]
    np.testing.assert_allclose(_cat(ranks, "batchnorm", "y"),
                               y.detach().numpy(), **GRADS)
    np.testing.assert_allclose(_cat(ranks, "batchnorm", "dx") / WORLD,
                               x.grad.numpy(), **GRADS)
    for r in ranks:   # the same running statistics on every rank
        for key, want in (("mean", bn.mean), ("var", bn.var),
                          ("dscale", bn.scale.grad),
                          ("dbias", bn.bias.grad)):
            np.testing.assert_allclose(r["batchnorm"][key], want.numpy(),
                                       err_msg=key, **GRADS)


def _single_step(group):
    model = tcomp.LearnableCompressor(group["tcfg"])
    model.load_state_dict(group["state0"])
    state = TrainState.create(model, main=OptimConfig(lr=1e-3))
    _, logs = train_step(state, tuple(map(_t, group["batch"])),
                         noise=_t(group["jax"]["noise"]))
    return model.state_dict(), {k: float(v) for k, v in logs.items()}


def test_train_step_matches_single_process_and_jax_sharded(group):
    """One update of the MLP compressor over 2 ranks: the single-process
    port's parameters, BatchNorm statistics and logs, and JAX's 8-device
    sharded step's (which is JAX's single-device step)."""
    single, slogs = _single_step(group)
    jparams, jstats, jlogs = group["jax"]["sharded"]
    jwant = tcomp.compressor_params_from_flax(jparams, jstats)
    for r in group["ranks"]:
        got, logs = r["step"]["state"], r["step"]["logs"]
        assert set(got) == set(single) == set(jwant)
        for name in got:
            np.testing.assert_allclose(got[name], single[name].numpy(),
                                       err_msg=name, **PARAMS)
            np.testing.assert_allclose(got[name], jwant[name].numpy(),
                                       err_msg=name, rtol=1e-4, atol=1e-5)
        for k in ("loss", "rate", "distortion"):
            np.testing.assert_allclose(logs[k], slogs[k], **LOSS)
            np.testing.assert_allclose(logs[k], jlogs[k], **LOSS)
    # the group's step moved the BatchNorm's running statistics
    assert not torch.equal(single["p_ZlX.mapper.MLP_0.BatchNorm_0.mean"],
                           group["state0"]["p_ZlX.mapper.MLP_0.BatchNorm_0.mean"])


def test_global_draws_are_one_devices_rows(group):
    rows = group["payload"]["draws"]["rows"]
    g = torch.Generator().manual_seed(5)
    noise = uniform_noise((WORLD * rows, 3), g, "cpu")
    two = uniform_noise((2 * WORLD * rows, 3), g, "cpu")
    banana = device_sample_batch(g, WORLD * rows)
    for r in group["ranks"]:
        d, k = r["draws"], r["rank"]
        mine = slice(k * rows, (k + 1) * rows)
        np.testing.assert_array_equal(d["noise"], noise[mine].numpy())
        # the two views: this rank's rows of each view's block
        want = torch.cat([two[:WORLD * rows][mine], two[WORLD * rows:][mine]])
        np.testing.assert_array_equal(d["two_views"], want.numpy())
        for a, b in zip(d["banana"], banana):
            np.testing.assert_allclose(a, b[mine].numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_main_on_two_ranks_matches_one(group):
    """`main(banana_viz_VIC, trainer.n_devices=2)` in the group against
    `n_devices=1`, at JAX's pipeline-mesh tolerances; rank 0 alone writes
    and reports."""
    m1 = group["main1"]
    m2, rest = group["ranks"][0]["main"], group["ranks"][1]["main"]
    assert rest == {}
    assert set(m2) == set(m1)
    for key in ("test/feat/loss", "test/feat/rate", "test/feat/distortion"):
        assert np.isfinite(m2[key])
        np.testing.assert_allclose(m2[key], m1[key], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(m2["test/comm/n_bits"], m1["test/comm/n_bits"],
                               rtol=1e-3)
    np.testing.assert_allclose(m2["test/pred/loss"], m1["test/pred/loss"],
                               rtol=2e-4, atol=2e-5)
    out = group["tmp"] / "two" / "out"
    assert len(list(out.rglob("featurizer_end.txt"))) == 1
    assert len(list(out.rglob("results_predictor.csv"))) == 1
