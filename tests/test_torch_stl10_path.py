"""The STL10 experiments of the port against the JAX package: one
training step.

One training step of a tiny `stl10_bince` (the contrastive distortion on
ResNet-18 at 96 px, two views, the factorized rate) and of a tiny
`stl10_balle` (BALLE with the spatial hyperprior, relu and GDN), from
JAX's weights on the same batch and draws: logs rtol 1e-4 / atol 1e-5,
the updated variables as tests/test_torch_mnist_path.py holds deep fp32
nets (rtol 1e-4 / atol 1e-5 of the largest entry, an Adam step may go
another way on at most 0.1% of the entries where the gradient is under
20% of its module's largest; ROADMAP queue 3 item 9). `main` of the six
presets, the probe's datasets and the experiment CLI are in
`tests/test_torch_stl10_main.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.compressors import rates as trates
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import state as tstate
from tests import torch_threads  # noqa: F401  (one pool a worker)

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
