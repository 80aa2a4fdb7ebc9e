"""K3's backward and its plan: the port's analytic VJP of the
entropy-bottleneck likelihood (`eb_kernel.likelihood_backward_plain`, the
arithmetic of the CUDA backward kernel) against JAX.

The JAX side is `jax.vjp` of `pallas_eb.eb_likelihood_fused` (its Pallas
forward in interpret mode on the CPU, its `custom_vjp` backward through the
reference chain), as tests/test_pallas_eb.py runs it. Tolerance: gradients
rtol 1e-4 (tests/test_pallas_eb.py's), with atol 2e-5 of the gradient's
largest entry: on moved coefficients the sums over the batch cancel and
both fp32 chains land up to ~5e-6 of that entry away from a float64
evaluation (test_torch_kernels_k3k4.py::test_k3_grads_match_pallas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.coding import entropy_bottleneck as jeb
from lossyless_tpu.coding import pallas_eb
from lossyless_tpu_torch.coding import eb_kernel
from lossyless_tpu_torch.coding import entropy_bottleneck as teb
from lossyless_tpu_torch.core.math import lower_bound
from tests import torch_threads  # noqa: F401  (one pool a worker)

SHAPES = [(37, 13, (3, 3, 3)), (128, 16, (3, 3, 3, 3)), (5, 8, (3, 3, 3)),
          (1, 1, (3, 3, 3, 3)), (9, 130, (2, 4)), (128, 102, (3, 3, 3, 3))]


def _eb_params(C, filters, seed, scale=0.3):
    """JAX init with every coefficient moved off its init value by
    N(0, scale) (the factors start at zero)."""
    p = jeb.init_params(jeb.EBConfig(C, filters), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) if k == "quantiles" else np.asarray(v)
                + rng.normal(0, scale, v.shape).astype(np.float32))
            for k, v in p.items()}


def _torch(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _inputs(B, C, seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(B, C)) * 4).astype(np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    return z, g


def _jax_vjp(p, z, g):
    """(dz, {name: grad}) of the JAX kernel's custom VJP at z (B, C)."""
    jp = {k: jnp.asarray(v) for k, v in p.items() if k != "quantiles"}
    _, vjp = jax.vjp(pallas_eb.eb_likelihood_fused, jp, jnp.asarray(z.T))
    gp, gz = vjp(jnp.asarray(g.T))
    return np.asarray(gz).T, {k: np.asarray(v) for k, v in gp.items()}


def _autograd(p, z, g):
    """(dz, {name: grad}) of torch autograd through the reference chain
    with lower_bound (`eb_kernel._reference`)."""
    tp = {k: torch.tensor(v, requires_grad=k != "quantiles")
          for k, v in p.items()}
    tz = torch.tensor(z, requires_grad=True)
    keys = [k for k in p if k != "quantiles"]
    grads = torch.autograd.grad(eb_kernel._reference(tp, tz),
                                [tz] + [tp[k] for k in keys],
                                torch.from_numpy(g))
    return grads[0].numpy(), {k: t.numpy() for k, t in zip(keys, grads[1:])}


def _plain(p, z, g):
    dz, grads = eb_kernel.likelihood_backward_plain(
        _torch(p), torch.from_numpy(z), torch.from_numpy(g))
    return dz.numpy(), {k: t.numpy() for k, t in grads.items()}


def _assert_close(got, want):
    (gz, gp), (wz, wp) = got, want
    assert sorted(gp) == sorted(wp)
    for name, a, b in [("z", gz, wz)] + [(k, gp[k], wp[k]) for k in wp]:
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=2e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("B,C,filters", SHAPES)
def test_k3_backward_plain_matches_jax_vjp(B, C, filters):
    p = _eb_params(C, filters, seed=B + C)
    z, g = _inputs(B, C, seed=B)
    _assert_close(_plain(p, z, g), _jax_vjp(p, z, g))


@pytest.mark.parametrize("B,C,filters", SHAPES)
def test_k3_backward_plain_matches_autograd(B, C, filters):
    p = _eb_params(C, filters, seed=B + C)
    z, g = _inputs(B, C, seed=B)
    _assert_close(_plain(p, z, g), _autograd(p, z, g))


def _tail(p, C):
    """Per channel, the first z >= 2 on a grid whose raw likelihood is
    below 1e-10 (floored) but not 0 (the sigmoids' slopes are not 0), and
    which channels have one."""
    grid = np.arange(2.0, 200.0, 0.25, dtype=np.float32)
    zz = torch.from_numpy(np.repeat(grid[:, None], C, axis=1))
    lik = teb.likelihood(_torch(p), zz).numpy()
    ok = (lik < 1e-10) & (lik > 0)
    return grid[ok.argmax(axis=0)], ok.any(axis=0)


def test_k3_backward_plain_floor_under_both_signs():
    """Floored likelihoods: lower_bound passes a gradient that pushes the
    likelihood up (g < 0) and blocks one that pushes it down (g > 0). The
    large |g| stands for -d log(lik) at the floor."""
    C = 12
    p = _eb_params(C, (3, 3, 3, 3), seed=5)
    z, g = _inputs(6, C, seed=5)
    tail, found = _tail(p, C)
    assert found.sum() >= 4
    z[:2, found] = tail[found]
    g[0, found], g[1, found] = 1e9, -1e9
    got = _plain(p, z, g)
    assert np.all(got[0][0, found] == 0) and np.all(got[0][1, found] != 0)
    _assert_close(got, _jax_vjp(p, z, g))
    _assert_close(got, _autograd(p, z, g))


def test_k3_backward_plain_tie_gives_zero():
    """Zero biases make the chain odd, so at z = 0 lower = -upper exactly:
    the sign is 0, both sigmoids are 1/2, D = 0 and the likelihood floors.
    No gradient flows there, under either sign of g."""
    C = 5
    p = _eb_params(C, (3, 3, 3), seed=2)
    p = {k: np.zeros_like(v) if k.startswith("bias") else v
         for k, v in p.items()}
    z, g = _inputs(4, C, seed=2)
    z[0] = z[1] = 0.0
    g[1] = -g[0]
    lik = teb.likelihood(_torch(p), torch.from_numpy(z)).numpy()
    assert np.all(lik[:2] == 0)
    got = _plain(p, z, g)
    assert np.all(got[0][:2] == 0)
    _assert_close(got, _jax_vjp(p, z, g))
    _assert_close(got, _autograd(p, z, g))


@pytest.mark.parametrize("want_z", [True, False])
def test_k3_backward_skips_what_autograd_does_not_ask(want_z):
    """Through the wrapper on the CPU: the plain backward's values, dz only
    when z needs it, parameter gradients only for those that need them."""
    p = _eb_params(7, (3, 3, 3), seed=1)
    z, g = _inputs(11, 7, seed=1)
    tz = torch.tensor(z, requires_grad=want_z)
    tp = {k: torch.tensor(v, requires_grad=not want_z and k == "bias1")
          for k, v in p.items()}
    eb_kernel.likelihood(tp, tz).backward(torch.from_numpy(g))
    wz, wp = _plain(p, z, g)
    if want_z:
        np.testing.assert_array_equal(tz.grad.numpy(), wz)
        assert all(t.grad is None for t in tp.values())
    else:
        assert tz.grad is None
        np.testing.assert_array_equal(tp["bias1"].grad.numpy(), wp["bias1"])
        assert all(t.grad is None for k, t in tp.items() if k != "bias1")


@pytest.mark.parametrize("filters,design,K", [
    ((3, 3, 3, 3), "fixed(3, 3, 3, 3)", 58), ((3, 3, 3), "fixed(3, 3, 3)", 43),
    ((2, 4), "generic", 27), ((3, 3), "generic", 28),
    ((5, 1, 8), "generic", 55), ((8,) * 7, "generic", 513)])
def test_k3_plan(filters, design, K):
    widths = (1, *filters, 1)
    plan = eb_kernel.k3_plan(128, 102, widths)
    assert (plan.design, plan.n_coeffs, plan.widths) == (design, K, widths)
    assert K == eb_kernel.n_coeffs(widths)
    assert plan.design_id == eb_kernel.FIXED.get(filters, eb_kernel.GENERIC)
    assert plan.blocks == 4 * eb_kernel.SPLIT      # 102 channels: 4 groups
    assert plan.threads == eb_kernel.WARPS * eb_kernel.CHANNELS
    assert plan.smem == 4 * K * eb_kernel.CHANNELS
    warps = plan.bwd_threads // eb_kernel.CHANNELS
    assert plan.bwd_smem == (1 + warps) * plan.smem <= eb_kernel.MAX_SMEM
    # as many warps as fit, at most WARPS: one more would not
    assert warps == eb_kernel.WARPS or \
        (2 + warps) * plan.smem > eb_kernel.MAX_SMEM
    assert warps >= 1


# clusters a card holds at once at 1..8 warps a block, forward and
# backward (an example; an H100 read 124 / 124 / 77 / 30 forward and
# 124 / 62 / 30 / 15 backward at 1 / 2 / 4 / 8 warps for fixed(3, 3, 3, 3))
RESIDENT = ((124, 124, 124, 124, 77, 77, 30, 30),
            (124, 62, 62, 30, 30, 15, 15, 15))


@pytest.mark.parametrize("C,fwd_warps,bwd_warps", [
    (102, 8, 8), (480, 8, 8), (512, 8, 5), (960, 8, 5), (1024, 6, 3),
    (3968, 4, 1), (4000, 8, 8)])
def test_k3_plan_keeps_every_cluster_resident(C, fwd_warps, bwd_warps):
    """The most warps a block with which every cluster (32 channels) is
    resident at once; where none is, the most warps."""
    plan = eb_kernel.k3_plan(128, C, (1, 3, 3, 3, 3, 1), RESIDENT)
    assert plan.threads == fwd_warps * eb_kernel.CHANNELS
    assert plan.bwd_threads == bwd_warps * eb_kernel.CHANNELS
    assert plan.bwd_smem == (1 + bwd_warps) * plan.smem
    assert eb_kernel.k3_plan(128, C, (1, 3, 3, 3, 3, 1)).bwd_threads == \
        eb_kernel.WARPS * eb_kernel.CHANNELS


@pytest.mark.parametrize("B,C,widths", [
    (0, 4, (1, 3, 1)), (4, 0, (1, 3, 1)), (2**31, 4, (1, 3, 1)),
    (4, 2**31, (1, 3, 1)), (4, 4, (1, 9, 1)), (4, 4, (1,) + (3,) * 8 + (1,)),
    (4, 4, (2, 3, 1)), (4, 4, (1, 0, 1))])
def test_k3_plan_limits(B, C, widths):
    with pytest.raises(ValueError):
        eb_kernel.k3_plan(B, C, widths)


def _bad_params(kind):
    p = _torch(_eb_params(4, (3, 3), seed=0))
    z = torch.zeros(2, 4)
    if kind == "dtype":
        p["bias1"] = p["bias1"].double()
    elif kind == "layout":   # same shape, transposed strides
        p["matrix1"] = p["matrix1"].transpose(1, 2).contiguous().transpose(
            1, 2)
    elif kind == "device":
        p["factor0"] = p["factor0"].to("meta")
    elif kind == "wide":
        p = _torch(_eb_params(4, (9,), seed=0))
    elif kind == "channels":
        z = torch.zeros(2, 5)
    return p, z


@pytest.mark.parametrize("kind,error,match", [
    ("dtype", TypeError, "float32"), ("layout", ValueError, "contiguous"),
    ("device", ValueError, "on the CPU or all on a CUDA"),
    ("wide", ValueError, "exceed"), ("channels", ValueError, "shape")])
def test_k3_wrapper_refuses(kind, error, match):
    p, z = _bad_params(kind)
    with pytest.raises(error, match=match):
        eb_kernel.likelihood(p, z)


# ---------------------------------------------------------------------------
# The |x| tie: JAX's `abs` has derivative +1 at 0, torch's 0
# ---------------------------------------------------------------------------

# one channel, widths (1, 1): softplus(-30) is so small that the chain
# rounds z - 0.5 and z + 0.5 to the same logit, 1.0, so D = 0 while both
# sigmoids' slopes are not 0; the likelihood floors and g = -1e9 passes
TIE = {"matrix0": np.full((1, 1, 1), -30.0, np.float32),
       "bias0": np.ones((1, 1, 1), np.float32)}
TIE_GRAD = 1.8398e-5    # d(-log lower_bound(lik)) / d matrix0 in JAX


def _jax_tie_grads():
    from lossyless_tpu.core.math import lower_bound as jlower_bound

    jp = {k: jnp.asarray(v) for k, v in TIE.items()}
    z = jnp.zeros((1, 1))

    def plain(p):
        lik = jlower_bound(jeb.likelihood(p, z), jeb.LIKELIHOOD_BOUND)
        return -jnp.log(lik).sum()

    def fused(p):
        return -jnp.log(pallas_eb.eb_likelihood_fused(p, z.T)).sum()

    return [float(jax.grad(f)(jp)["matrix0"][0, 0, 0])
            for f in (plain, fused)]


@pytest.mark.parametrize("path", ["likelihood", "backward_plain", "wrapper"])
def test_k3_abs_tie_matches_jax(path):
    """Queue 3 item 7's case: JAX's d/d matrix0 is 1.8398e-5 through both
    `eb.likelihood` and `eb_likelihood_fused`'s `_bwd`; the port's plain
    likelihood, its analytic backward and the wrapper give the same."""
    want = _jax_tie_grads()
    np.testing.assert_allclose(want, [TIE_GRAD] * 2, rtol=1e-4)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in TIE.items()}
    z = torch.zeros(1, 1)
    if path == "backward_plain":
        lik = eb_kernel.likelihood_plain(tp, z)
        _, grads = eb_kernel.likelihood_backward_plain(tp, z, -1.0 / lik)
        got = grads["matrix0"]
    else:
        lik = teb.likelihood(tp, z) if path == "likelihood" \
            else eb_kernel.likelihood(tp, z)
        if path == "likelihood":
            lik = lower_bound(lik, teb.LIKELIHOOD_BOUND)
        # the floored tie
        assert float(lik.detach()) == np.float32(teb.LIKELIHOOD_BOUND)
        (got,) = torch.autograd.grad(-torch.log(lik).sum(), tp["matrix0"])
    np.testing.assert_allclose(float(got), want[0], rtol=1e-5)


def test_aux_loss_abs_tie_matches_jax():
    """Zero biases and a zero median quantile put the median's logit on
    its target, 0: JAX's gradient to that quantile is d|x| = 1 times the
    chain's slope."""
    p = _eb_params(3, (3, 3), seed=4)
    p = {k: np.zeros_like(v) if k.startswith("bias") else np.array(v)
         for k, v in p.items()}
    p["quantiles"][:, 0, 1] = 0.0
    want = jax.grad(jeb.aux_loss)({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    teb.aux_loss(tp).backward()
    got = tp["quantiles"].grad.numpy()
    assert np.all(np.asarray(want["quantiles"])[:, 0, 1] != 0)
    np.testing.assert_allclose(got, np.asarray(want["quantiles"]),
                               rtol=1e-5, atol=1e-7)


def test_lossy_z_abs_tie_matches_jax():
    """`lossy_Z` at p_norm = 1 where z_hat equals the mean: JAX's gradient
    is 1 there."""
    from lossyless_tpu.compressors import distortions as jd
    from lossyless_tpu.compressors import distributions as jdistr
    from lossyless_tpu_torch.compressors import distortions as td
    from lossyless_tpu_torch.compressors import distributions as tdistr

    rng = np.random.default_rng(3)
    z_hat = rng.normal(size=(4, 6)).astype(np.float32)
    mean = z_hat.copy()
    mean[:, ::2] += 1.0           # every other entry off the tie
    cfg = jd.DistortionConfig(mode="lossy_Z", p_norm=1.0)

    def jloss(zh):
        p = jdistr.from_suff_param("deterministic", jnp.asarray(mean))
        return jd.LossyZDistortion(cfg).apply({}, zh, None, p)[0].sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(z_hat)))
    tz = torch.tensor(z_hat, requires_grad=True)
    p = tdistr.from_suff_param("deterministic", torch.from_numpy(mean))
    td.LossyZDistortion(td.DistortionConfig(mode="lossy_Z", p_norm=1.0))(
        tz, None, p)[0].sum().backward()
    assert np.all(want[:, 1::2] == 1.0)
    np.testing.assert_allclose(tz.grad.numpy(), want, rtol=1e-6)
