"""The contrastive distortion and the two-view step against the JAX package.

`ContrastiveDistortion` on the same inputs and weights (fp32: rel 1e-5 /
abs 1e-6 on the loss and the logs; every gradient, `logit_scale`'s
included, at the repository's gradient tolerance, `_grad_tol`): cosine logits on and off, the projector on and off, the
effective-batch-size reweighting off and on; a zero row (unprojected, and
a projector whose ReLU is dead on that row), whose gradient must be finite
and equal; and the temperature's clip: below its bound (gradient through
the exp), above it at `logit_scale = log(100)` (exp gives 100.0000076 in
fp32 in both frameworks: no gradient), and at it exactly (JAX's clip
splits the gradient in half there; `torch.clamp` would pass all of it).

The two-view step of `LearnableCompressor` in both forms, the default
two-pass (the positive encoded after the anchor, BatchNorm statistics
updated twice) and `concat_views` (one 2B batch), through 3 training steps
of `banana_viz_BINCE` held to JAX's logs and parameters
(`test_torch_banana.check_preset_steps`: rel 1e-5 / abs 1e-6 or twice
JAX's own one-ulp spread); and with a Gaussian encoder and the `MI` rate,
whose samples of both views are JAX's draws handed over; and `main` of
`banana_viz_BINCE` writing JAX's results-CSV keys for the three stages.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors import distortions as jdist
from lossyless_tpu_torch.compressors import distortions as tdist
from lossyless_tpu_torch.nn.mlp import params_from_flax
from lossyless_tpu_torch.pipeline import run as trun
from tests.test_torch_banana import (STAGES, _csv_keys, _tiny,
                                     check_preset_steps, jax_results_keys)
from tests import torch_threads  # noqa: F401  (one pool a worker)

TOL = dict(rtol=1e-5, atol=1e-6)
B, Z = 12, 4


def _inputs(seed=0, zero_row=False):
    rng = np.random.default_rng(seed)
    z, zp = (rng.normal(size=(B, Z)).astype(np.float32) for _ in range(2))
    if zero_row:
        z[3] = 0.0
    return z, zp


def _run_both(cfg_kw, z, zp, params=None, logit_scale=None):
    """(JAX, port): loss, logs and the gradients of the summed loss with
    respect to the parameters and both inputs."""
    jcfg = jdist.DistortionConfig(mode="contrastive", **cfg_kw)
    jm = jdist.ContrastiveDistortion(jcfg)
    if params is None:
        params = jm.init(jax.random.key(1), jnp.asarray(z),
                         jnp.asarray(zp))["params"]
        params = jax.tree.map(np.asarray, params)
    if logit_scale is not None:
        params = {**params, "logit_scale": np.float32(logit_scale)}

    def jloss(p, a, b):
        dist, logs = jm.apply({"params": p}, a, b, training=True)
        return dist.sum(), (dist, logs)

    (_, (jdist_, jlogs)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(z), jnp.asarray(zp))

    tm = tdist.make_distortion_estimator(tdist.DistortionConfig(
        mode="contrastive", **cfg_kw), Z, None)
    tm.load_state_dict(params_from_flax(params))
    tz, tzp = (torch.from_numpy(a).requires_grad_(True) for a in (z, zp))
    tdist_, tlogs = tm(tz, tzp, training=True)
    tdist_.sum().backward()
    want = params_from_flax(jax.tree.map(np.asarray, jgrads[0]))
    got = {k: v.grad for k, v in tm.named_parameters()}
    assert set(got) == set(want)
    return ((np.asarray(jdist_), jlogs, want, np.asarray(jgrads[1]),
             np.asarray(jgrads[2])),
            (tdist_.detach().numpy(), tlogs, got, tz.grad.numpy(),
             tzp.grad.numpy()))


def _assert_same(j, t):
    jd, jlogs, jgrads, jgz, jgzp = j
    td, tlogs, tgrads, tgz, tgzp = t
    np.testing.assert_allclose(td, jd, **TOL)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(tlogs[k]) == pytest.approx(float(jlogs[k]), rel=1e-5,
                                                abs=1e-6), k
    for k in jgrads:
        g = tgrads[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, jgrads[k].numpy(), err_msg=k,
                                   **_grad_tol(jgrads[k].numpy()))
    for g, w in ((tgz, jgz), (tgzp, jgzp)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **_grad_tol(w))


def _grad_tol(want) -> dict:
    """The repository's gradient tolerance (tests/test_pallas_eb.py, K3's
    backward): rtol 1e-4, atol 2e-5 of the largest entry. The logits are
    scaled by up to 100 and summed over the batch, so an entry far below
    the largest is a difference of large terms: JAX and the port are each
    ~6e-6 off the float64 gradient on entries of ~20."""
    return dict(rtol=1e-4, atol=2e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("is_cosine", [True, False])
@pytest.mark.parametrize("is_project", [True, False])
@pytest.mark.parametrize("effective_batch_size", [None, 100.0])
def test_contrastive_distortion_matches_jax(is_cosine, is_project,
                                            effective_batch_size):
    kw = dict(is_cosine=is_cosine, is_project=is_project, project_dim=8,
              effective_batch_size=effective_batch_size)
    j, t = _run_both(kw, *_inputs())
    _assert_same(j, t)
    assert float(t[1]["n_negatives"]) == 2 * B - 1
    assert "logit_scale" in t[2] and t[2]["logit_scale"].abs() > 0


def test_fixed_temperature_matches_jax():
    kw = dict(is_train_temperature=False, temperature=0.1, project_dim=8)
    j, t = _run_both(kw, *_inputs(1))
    _assert_same(j, t)
    assert "logit_scale" not in t[2]


def test_zero_row_has_a_finite_equal_gradient():
    z, zp = _inputs(2, zero_row=True)
    j, t = _run_both(dict(is_project=False), z, zp)
    _assert_same(j, t)
    # a projector whose ReLU is dead on the zero row outputs its last
    # bias (0 at init): a zero row after the projection too
    kw = dict(project_dim=8)
    params = jax.tree.map(np.asarray, jdist.ContrastiveDistortion(
        jdist.DistortionConfig(mode="contrastive", **kw)).init(
        jax.random.key(3), jnp.asarray(z), jnp.asarray(zp))["params"])
    proj = dict(params["projector"])
    proj["Dense_0"] = {**proj["Dense_0"],
                       "bias": np.full_like(proj["Dense_0"]["bias"], -1.0)}
    params = {**params, "projector": proj}
    j, t = _run_both(kw, z, zp, params=params)
    _assert_same(j, t)


def test_temperature_clip_gradients_match_jax():
    z, zp = _inputs(4)
    kw = dict(project_dim=8)
    # below the bound: the gradient runs through exp(logit_scale)
    j, t = _run_both(kw, z, zp, logit_scale=np.log(np.float32(20)))
    _assert_same(j, t)
    assert abs(float(t[2]["logit_scale"])) > 0
    # log(100): exp gives 100.0000076 > 1 / 0.01, the clip holds it
    j, t = _run_both(kw, z, zp, logit_scale=np.log(np.float32(100)))
    _assert_same(j, t)
    assert float(t[2]["logit_scale"]) == 0.0
    # exactly at the bound: JAX's clip passes half the gradient
    ls = np.log(np.float32(100))
    at = float(torch.exp(torch.tensor(ls)))
    tie = dict(kw, temperature=1.0 / at)
    j, t = _run_both(tie, z, zp, logit_scale=ls)
    _assert_same(j, t)
    below = dict(kw, temperature=1.0 / (2 * at))
    jb, tb = _run_both(below, z, zp, logit_scale=ls)
    # the loss through the unclipped scale, at the same point
    assert float(t[2]["logit_scale"]) == pytest.approx(
        float(tb[2]["logit_scale"]) / 2, rel=1e-5)


@pytest.mark.parametrize("form", [(), ("distortion.concat_views=True",)],
                         ids=["two_pass", "concat_views"])
def test_two_view_step_matches_jax(form):
    check_preset_steps("banana_viz_BINCE", form)


@pytest.mark.parametrize("form", [(), ("distortion.concat_views=True",)],
                         ids=["two_pass", "concat_views"])
def test_two_view_step_with_gaussian_samples_and_mi_matches_jax(form):
    check_preset_steps("banana_viz_BINCE", form + (
        "encoder.family=diaggaussian", "rate.mode=MI"))


def test_bince_main_writes_jaxs_results(tmp_path):
    """`main` of banana_viz_BINCE: the three stages, with JAX's results-CSV
    keys (`I_q_zm`, `hat_H_m`, `n_negatives` among the featurizer's)."""
    want = jax_results_keys("banana_viz_BINCE", tmp_path / "jax")
    cfg = _tiny("banana_viz_BINCE", tmp_path / "port")
    metrics = trun.main(cfg, device="cpu")
    for stage in STAGES:
        assert (Path(cfg.stage_dir) / f"{stage}_end.txt").exists()
        assert _csv_keys(cfg.stage_dir, stage) == want[stage], stage
    assert math.isfinite(metrics["test/feat/I_q_zm"])
    assert metrics["test/feat/n_negatives"] == 2 * 128 - 1
