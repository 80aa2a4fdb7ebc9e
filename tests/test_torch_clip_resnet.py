"""CLIP's ModifiedResNet (`nn/clip_resnet.py`) against flax's.

The same numpy-seeded images go through JAX's `ClipResNet.apply` on the
CPU (its attention pool on the einsum path, `_reference_attention_cls`)
and the port's tower (K2's plain version on CPU tensors), with JAX's
weights, every coefficient moved off its init and the running statistics
set away from theirs, carried over by `layers.params_from_flax`.

Tolerances: fp32 rtol 1e-5 with atol 1e-5 of the largest entry (the
sums of a conv or a norm in another order); bf16 atol 2e-2 of the
largest entry (tests/test_flash_attn.py's bf16 tolerance; both sides
round at flax's points, the average pools too). In train mode BatchNorm
normalizes with statistics of 4 images, which amplifies the bf16
rounding flips that fp32 roundoff in the statistics sets off: the port's
output lies 1-4.5 bf16 ulps of its largest entry from JAX's (batches of
3-8, seeds 0-2, at 64 and 100 px), while JAX's own output moves by up
to 0.031 when its input moves by one fp32 ulp. The full-depth tower is
held to the float64 network instead, at most 1.5 x JAX's own distance
from it (tests/test_torch_resnet_cnn.py's rule for ResNet-50; ROADMAP
queue 3 item 9).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.nn import clip_resnet as jcr
from lossyless_tpu_torch.nn import clip_resnet as tcr
from lossyless_tpu_torch.nn import layers as tlayers
from lossyless_tpu_torch.nn import registry
from tests import torch_threads  # noqa: F401  (one pool a worker)

TINY = dict(layers=(1, 1, 1, 1), width=16, heads=4)
OUT, B = 8, 4
BF16_RATIO = 2.5


def _vars(jm, x, seed=0, scale=0.05):
    """flax init on x, every param moved by N(0, scale), the running
    statistics to mean ~N(0, 0.1), var ~U(0.5, 1.5)."""
    v = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, scale, a.shape).astype(np.float32), v["params"])

    def stats(t):
        if "mean" in t:
            return {"mean": rng.normal(0, 0.1, t["mean"].shape).astype(
                np.float32), "var": rng.uniform(0.5, 1.5, t["var"].shape)
                .astype(np.float32)}
        return {k: stats(s) for k, s in t.items()}

    return params, stats(jax.tree.map(np.asarray, v["batch_stats"]))


def _port(in_shape, dtype, params, stats, **kw):
    tm = registry.get_architecture("clip_rn50", in_shape, OUT, dtype=dtype,
                                   **{**TINY, **kw})
    tm.load_state_dict(tlayers.params_from_flax(
        tlayers.merge_stats(params, stats)))
    return tm


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2 * scale)


def _jax_train(jm, params, stats, x, w, dtype=None, grad=True):
    """JAX in train mode, jitted: (output, updated statistics, d sum(out *
    w) / dx, or None without `grad`), in float64 (x64 mode, restored
    after) when dtype says so."""
    f64 = dtype == "float64"
    if f64:
        jax.config.update("jax_enable_x64", True)
        jm = jm.clone(dtype="float64", attn_impl="einsum")
    try:
        cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, jnp.float64 if f64 else jnp.float32))
        variables = {"params": cast(params), "batch_stats": cast(stats)}

        @jax.jit
        def run(xj):
            def scalar(xj):
                out, new = jm.apply(variables, xj, training=True,
                                    mutable=["batch_stats"])
                return jnp.sum(out * w), (out, new["batch_stats"])
            if not grad:
                return scalar(xj)[1], None
            (_, aux), dx = jax.value_and_grad(scalar, has_aux=True)(xj)
            return aux, dx

        (out, new), dx = run(cast(x))
        return jax.tree.map(lambda a: np.asarray(a, np.float64),
                            (out, new, dx))
    finally:
        if f64:
            jax.config.update("jax_enable_x64", False)


def _held_to_float64(name, got, want, ref, ratio):
    """The port at most `ratio` x JAX's own distance from the float64
    network, in the largest and in the root-mean-square difference
    (floor: 1e-5 of the largest entry)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    floor = 1e-5 * np.abs(ref).max()
    for dist in (lambda a: np.abs(a - ref).max(),
                 lambda a: np.sqrt(np.mean((a - ref) ** 2))):
        assert dist(got) <= max(ratio * dist(want), floor), name


@functools.lru_cache(maxsize=None)
def _case(side):
    """Images, the scalar's weights and JAX's moved variables at `side`
    (flax keeps fp32 parameters whatever the compute dtype)."""
    x = np.random.default_rng(side).normal(size=(B, side, side, 3)).astype(
        np.float32)
    w = np.random.default_rng(1).normal(size=(B, OUT)).astype(np.float32)
    return (x, w, *_vars(jcr.ClipResNet(out_dim=OUT, **TINY), x))


@functools.lru_cache(maxsize=None)
def _float64_train(side):
    x, w, params, stats = _case(side)
    return _jax_train(jcr.ClipResNet(out_dim=OUT, **TINY), params, stats,
                      x, w, "float64")


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [64, 100])
def test_tower_matches_flax(side, dtype, training):
    """Output, held to JAX's; in train mode also the updated running
    statistics and the gradient of a scalar of the output with respect to
    the input. Train mode's BatchNorm backward cancels (ROADMAP queue 3
    item 9: fp32 gradients of a BatchNorm network lie up to ~16% of their
    largest entry from float64), and its bf16 forward amplifies rounding
    flips past a fixed tolerance (the module docstring): there the
    gradient in both dtypes, and the bf16 output and statistics, are held
    to the float64 network: the fp32 gradient at 1.5 x JAX's distance
    from it, the bf16 quantities at `BF16_RATIO` x (the port's bf16
    distance read 1.0-2.2 x JAX's over seeds 0-2 at both sides, the
    largest and the root-mean-square difference alike)."""
    x, w, params, stats = _case(side)
    jm = jcr.ClipResNet(out_dim=OUT, dtype=dtype, **TINY)
    tm = _port((side, side, 3), dtype, params, stats)
    xt = torch.from_numpy(x).requires_grad_(training)
    got = tm(xt, training=training)
    if not training:
        want = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                                 jnp.asarray(x))
        _close(got.detach(), want, dtype)
        return
    (got * torch.from_numpy(w)).sum().backward()
    want = _jax_train(jm, params, stats, x, w)
    ref = _float64_train(side)
    sd = tm.state_dict()
    flat = [tlayers.params_from_flax(t[1]) for t in (want, ref)]
    assert flat[0] and all(k.endswith((".mean", ".var")) for k in flat[0])
    pairs = [("output", got.detach(), want[0], ref[0])] + [
        (k, sd[k], v, flat[1][k].double()) for k, v in flat[0].items()]
    for name, g, wv, r in pairs:
        if dtype == "float32":
            _close(g, wv, dtype)
        else:
            _held_to_float64(name, g, wv, r, BF16_RATIO)
    _held_to_float64("d/dx", xt.grad, want[2], ref[2],
                     1.5 if dtype == "float32" else BF16_RATIO)


@pytest.mark.parametrize("side,grid", [(224, 7), (96, 3), (64, 2), (100, 3),
                                       (65, 2), (40, 1)])
def test_token_grid_is_flax_arithmetic(side, grid):
    """(H - 1) // 2 + 1 after the stem, floored by each 2x2 pool: not
    (H / 32)^2 + 1 off multiples of 32 (100 px: 50 -> 25 -> 12 -> 6 -> 3);
    the pool's positional embedding has flax's shape."""
    assert tcr.token_grid(side, side) == (grid, grid)
    tm = registry.get_architecture("clip_rn50", (side, side, 3), OUT, **TINY)
    jm = jcr.ClipResNet(out_dim=OUT, **TINY)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, side, side, 3)))
    want = shapes["params"]["attnpool"]["positional_embedding"].shape
    assert tuple(tm.attnpool.positional_embedding.shape) == want \
        == (grid * grid + 1, 16 * 32)


def test_pool_runs_k2_and_the_plain_version_alike():
    """`attn_impl` pallas/auto -> the kernel's wrapper (its plain version
    on CPU tensors), einsum -> the plain version: one function, the same
    output."""
    x, _, params, stats = _case(64)
    outs = []
    for impl in ("pallas", "auto", "einsum"):
        tm = _port((64, 64, 3), "float32", params, stats, attn_impl=impl)
        assert tm.attnpool.attn_impl == ("plain" if impl == "einsum"
                                         else "kernel")
        outs.append(tm(torch.from_numpy(x)).detach())
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="in_shape"):
        tm(torch.zeros(1, 96, 96, 3))


def test_avg_pool_rounds_as_flax():
    """bf16 pools: the taps summed one at a time in bf16, as flax's
    `avg_pool` is; odd sizes floor."""
    import flax.linen as fnn

    x = np.random.default_rng(4).normal(size=(2, 9, 7, 32)).astype(
        np.float32)
    want = fnn.avg_pool(jnp.asarray(x, jnp.bfloat16), (2, 2), (2, 2))
    got = tcr.avg_pool(torch.from_numpy(x).to(torch.bfloat16)
                       .permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_full_depth_tower_holds_to_float64():
    """The full-depth tower ((3, 4, 6, 3), 32 heads) at width 16 on 64 px
    images in train mode: output and updated statistics at most 1.5 x
    JAX's fp32 distance from the float64 network (the gradient is held on
    the tiny towers above)."""
    kw = dict(layers=(3, 4, 6, 3), width=16, heads=32)
    x = np.random.default_rng(9).normal(size=(3, 64, 64, 3)).astype(
        np.float32)
    w = np.random.default_rng(1).normal(size=(3, OUT)).astype(np.float32)
    jm = jcr.ClipResNet(out_dim=OUT, **kw)
    params, stats = _vars(jm, x, seed=2)
    want = _jax_train(jm, params, stats, x, w, grad=False)
    ref = _jax_train(jm, params, stats, x, w, "float64", grad=False)
    tm = registry.get_architecture("clip_rn50", (64, 64, 3), OUT, **kw)
    tm.load_state_dict(tlayers.params_from_flax(
        tlayers.merge_stats(params, stats)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), training=True)
    sd = tm.state_dict()
    flat, flat_ref = (tlayers.params_from_flax(t[1]) for t in (want, ref))
    pairs = [("output", got, want[0], ref[0])]
    pairs += [(k, sd[k], v, flat_ref[k]) for k, v in flat.items()]
    assert len(pairs) == 1 + 2 * (3 + 3 * 16 + 4)
    for name, g, wv, r in pairs:
        _held_to_float64(name, g, wv, r, 1.5)
