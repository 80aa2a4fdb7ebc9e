"""K6, BatchNorm's hand-written forward and backward (`nn/bn_kernel.py`,
`nn/csrc/batchnorm.cu`).

On the CPU: the analytic backward `batchnorm_backward_plain` (the
reference the kernels' backward is held to) against autograd through the
eager chain (`BatchNorm.eager`, and the same chain in float64), with
channels_last 4-D and 2-D inputs, training and eval, C not a multiple of
8 and a constant channel whose fast variance the clamp cuts to 0; `bn_plan`
over every BatchNorm shape of the `bince.train` cell, banana's (1024, 1024)
MLP and a tiny shape; `row_layout` and the wrapper's refusals.

On the card (marked `card`, skipped without one; `python -m pytest
--noconftest -m card tests/test_torch_bn_k6.py`): the kernels against the
eager chain at the ResNet-18 stem's and layer 4's shapes in bf16 and the
MLP's in fp32, each output's error against float64 at most twice the
chain's; two calls bit-equal; the launch counts; a cropped (strided-row)
input, C = 13 and eval mode; an NCHW input refused; a constant channel
whose clamp binds in K6's own sums, its backward held to
`batchnorm_backward_plain` in float64; a world of one NCCL rank bit-equal
to no group; a world of two (a second rank with the same rows, emulated)
equal to the doubled batch without a group.

Tolerances, with their reasons: float64 rtol 1e-10 (the same function,
summed in another grouping); float32 rtol 1e-4 / atol 1e-5 of the largest
entry (the statistics' gradient terms cancel, and the chain and the plain
version group them differently); bfloat16 rtol 2^-7 (one rounding of an
fp32 value that moved with the summation order: at most one bf16 step).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from lossyless_tpu_torch.nn import bn_kernel, layers
from tests import torch_threads  # noqa: F401  (one pool a worker)

EPS = 1e-5
TOL = {torch.float64: dict(rtol=1e-10, atol=1e-12),
       torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=2**-7, atol=1e-5)}

# BatchNorm inputs (rows, C) of one view of bince.train (ResNet-18, small
# stem, 256 images of 96 px): the stem and layer 1, layers 2-4 (their
# first blocks' shortcuts have the same shapes)
CELL_SHAPES = [(256 * 96 * 96, 64), (256 * 48 * 48, 128),
               (256 * 24 * 24, 256), (256 * 12 * 12, 512)]
MLP_SHAPE = (1024, 1024)   # banana's MLP with norm_layer="batchnorm"


def _eager(x, scale, bias, run_mean, run_var, training):
    """The eager chain of `BatchNorm.eager` in x's dtype (float64 here)."""
    dims = layers._stat_dims(x)
    if training:
        mean, var = layers._fast_stats(x, dims)
    else:
        mean, var = (layers._per_channel(v, x) for v in (run_mean, run_var))
    return (x - mean) * torch.rsqrt(var + EPS) \
        * layers._per_channel(scale, x) + layers._per_channel(bias, x)


def _input(shape, dtype, seed, constant=None):
    """Channels innermost: a channels_last 4-D tensor, else (B, C); a mean
    off 0 per channel; channel 0 held at `constant`."""
    g = torch.Generator().manual_seed(seed)
    if len(shape) == 4:
        n, c, h, w = shape
        x = (torch.randn((n, h, w, c), generator=g, dtype=torch.float64)
             * 1.5 + 0.3).permute(0, 3, 1, 2)
    else:
        x = torch.randn(shape, generator=g, dtype=torch.float64) * 1.5 + 0.3
    if constant is not None:
        x[:, 0] = constant
    return x.to(dtype)


def _forward_stats(x, eps=EPS):
    """(3, C): the batch's mean, rstd and clamp flag (1 where E[x^2] -
    E[x]^2 >= 0, where torch.clamp passes its input's gradient) in x's
    dtype, by `layers._fast_stats`'s formula: the statistics K6's forward
    saves for its backward."""
    dims = (0,) + tuple(range(2, x.dim()))
    mean = x.mean(dims)
    raw = (x * x).mean(dims) - mean * mean
    rstd = torch.rsqrt(torch.clamp(raw, min=0) + eps)
    return torch.stack([mean, rstd, (raw >= 0).to(x.dtype)])


def _binding_constant(shape, dtype, seed):
    """A value whose constant channel 0 gets E[x^2] - E[x]^2 < 0 by the
    chain's own arithmetic (the clamp binds there)."""
    for i in range(1, 400):
        x = _input(shape, dtype, seed, constant=i / 97)
        if _forward_stats(x)[2, 0] == 0:
            return i / 97
    raise AssertionError("no constant makes the fast variance negative")


def _params(C, dtype, seed):
    g = torch.Generator().manual_seed(seed + 1)
    scale = (torch.rand(C, generator=g, dtype=torch.float64) + 0.5)
    bias = torch.randn(C, generator=g, dtype=torch.float64)
    run_mean = torch.randn(C, generator=g, dtype=torch.float64) * 0.2
    run_var = torch.rand(C, generator=g, dtype=torch.float64) + 0.5
    return [t.to(dtype) for t in (scale, bias, run_mean, run_var)]


def _autograd(x, scale, bias, run_mean, run_var, training, dy):
    """dx, dscale, dbias by autograd through the eager chain: the module's
    own (`BatchNorm.eager`) in float32, the same formula in float64."""
    x = x.clone().requires_grad_()
    if x.dtype == torch.float32:
        bn = layers.BatchNorm(x.shape[1], EPS)
        with torch.no_grad():
            for t, v in zip((bn.scale, bn.bias, bn.mean, bn.var),
                            (scale, bias, run_mean, run_var)):
                t.copy_(v)
        y = bn.eager(x, training=training)
        y.backward(dy)
        return x.grad, bn.scale.grad, bn.bias.grad
    s, b = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    y = _eager(x, s, b, run_mean, run_var, training)
    y.backward(dy)
    return x.grad, s.grad, b.grad


def _stats(x, run_mean, run_var, training):
    if training:
        return _forward_stats(x)
    return torch.stack([run_mean, torch.rsqrt(run_var + EPS),
                        torch.ones_like(run_mean)])


def _close(got, want, dtype):
    tol = TOL[dtype]
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(scale, 1.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["4d", "2d"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("C", [16, 13])
def test_backward_plain_matches_autograd(dtype, layout, training, C):
    shape = (6, C, 5, 7) if layout == "4d" else (40, C)
    x = _input(shape, dtype, seed=C, constant=0.25)
    scale, bias, run_mean, run_var = _params(C, dtype, seed=C)
    dy = _input(shape, dtype, seed=C + 100)
    want = _autograd(x, scale, bias, run_mean, run_var, training, dy)
    got = bn_kernel.batchnorm_backward_plain(
        x, dy, scale, _stats(x, run_mean, run_var, training), training)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["4d", "2d"])
def test_clamped_channel_gets_no_variance_gradient(dtype, layout):
    """Where E[x^2] - E[x]^2 < 0 the clamp passes no gradient: autograd
    and the plain backward give that channel's dx without the variance's
    term, only scale rstd dy - rstd scale S1 / n."""
    shape = (6, 8, 5, 7) if layout == "4d" else (40, 8)
    c = _binding_constant(shape, dtype, seed=3)
    x = _input(shape, dtype, seed=3, constant=c)
    scale, bias, run_mean, run_var = _params(8, dtype, seed=3)
    dy = _input(shape, dtype, seed=103)
    stats = _forward_stats(x)
    assert stats[2, 0] == 0 and bool(stats[2, 1:].all())
    want = _autograd(x, scale, bias, run_mean, run_var, True, dy)
    got = bn_kernel.batchnorm_backward_plain(x, dy, scale, stats, True)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    n = x.numel() // 8
    rstd = stats[1, 0]
    s1 = dy[:, 0].sum()
    no_var = scale[0] * rstd * dy[:, 0] - rstd * scale[0] * s1 / n
    _close(got[0][:, 0], no_var, dtype)


def test_cpu_batchnorm_is_the_eager_chain():
    """On the CPU `BatchNorm` is `BatchNorm.eager` bit for bit: outputs,
    running statistics and gradients (the JAX parity tests see no
    change)."""
    x = _input((4, 16, 6, 6), torch.bfloat16, seed=9)
    dy = _input((4, 16, 6, 6), torch.float32, seed=10)
    outs = []
    for path in ("forward", "eager"):
        bn = layers.BatchNorm(16)
        xi = x.clone().requires_grad_()
        y = getattr(bn, path)(xi, training=True)
        y.backward(dy)
        outs.append([y.detach(), bn.mean, bn.var, xi.grad, bn.scale.grad,
                     bn.bias.grad])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# bn_plan, row_layout, the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,C,dtype", [
    *((r, c, "bfloat16") for r, c in CELL_SHAPES),
    (*MLP_SHAPE, "float32"), (3, 5, "float32"), (1, 1, "bfloat16"),
    (1000, 13, "bfloat16"), (777, 24, "float32")])
def test_bn_plan_covers_every_row_in_a_fixed_order(rows, C, dtype):
    plan = bn_kernel.bn_plan(rows, C, dtype)
    assert plan == bn_kernel.bn_plan(rows, C, dtype, True, bn_kernel.SMS)
    # the block: at most THREADS threads, at most LANES along the channels
    assert 1 <= plan.tc <= bn_kernel.LANES
    assert plan.tc * plan.tr <= bn_kernel.THREADS
    assert plan.tr == bn_kernel.THREADS // plan.tc
    # the slices cover the channels, each thread 16 bytes of them or one
    width = plan.tc * plan.vec
    assert (plan.slices - 1) * width < C <= plan.slices * width
    assert plan.vec in (1, 16 // bn_kernel.ITEMSIZE[dtype])
    assert C % plan.vec == 0
    # tile t owns rows [t rows_per_tile, (t + 1) rows_per_tile): the tiles
    # cover every row once, none is empty, each a whole number of the
    # block's row lanes (the order the finalize sums them in is the
    # kernel's; the card tests hold two calls bit-equal)
    assert 1 <= plan.tiles <= bn_kernel.MAX_TILES
    assert (plan.tiles - 1) * plan.rows_per_tile < rows \
        <= plan.tiles * plan.rows_per_tile
    assert plan.rows_per_tile % plan.tr == 0
    # shared memory: the block sums fit the static 48 KB and the card's
    # 227 KB
    assert plan.smem <= bn_kernel.RED_SMEM <= 48 * 1024 <= bn_kernel.MAX_SMEM
    assert plan.scratch_floats == plan.tiles * 2 * C


@pytest.mark.parametrize("rows,C", CELL_SHAPES)
def test_bn_plan_at_the_cell_fills_the_card(rows, C):
    """The cell's shapes: 16-byte loads, and one wave that fills the card:
    at least two blocks an SM, none beyond what the card holds at once."""
    plan = bn_kernel.bn_plan(rows, C, "bfloat16")
    assert plan.vec == 8
    blocks = plan.tiles * plan.slices
    assert 2 * bn_kernel.SMS <= blocks <= bn_kernel.RESIDENT * bn_kernel.SMS
    assert math.ceil(rows / plan.tiles) >= plan.tr   # each lane has rows


def test_bn_plan_unaligned_and_odd_channels_take_one_channel_a_thread():
    assert bn_kernel.bn_plan(4096, 64, "bfloat16", aligned=False).vec == 1
    assert bn_kernel.bn_plan(4096, 60, "bfloat16").vec == 1
    assert bn_kernel.bn_plan(4096, 60, "float32").vec == 4
    assert bn_kernel.bn_plan(*MLP_SHAPE, "float32").vec == 4


@pytest.mark.parametrize("rows,C,dtype", [(0, 4, "float32"),
                                          (4, 0, "float32"),
                                          (4, 4, "float16")])
def test_bn_plan_refuses(rows, C, dtype):
    with pytest.raises(ValueError):
        bn_kernel.bn_plan(rows, C, dtype)


def test_row_layout():
    x = torch.zeros(2, 8, 6, 5).contiguous(memory_format=torch.channels_last)
    assert bn_kernel.row_layout(x) == ((1, 1, 60), (0, 0, 8))
    assert bn_kernel.row_layout(torch.zeros(7, 3)) == ((1, 1, 7), (0, 0, 3))
    # a transposed convolution's crop: rows over three strided dims
    crop = x[:, :, :5, :4]
    assert bn_kernel.row_layout(crop) == ((2, 5, 4), (240, 40, 8))
    # size-1 dims drop out
    one = torch.zeros(1, 8, 1, 5).contiguous(memory_format=torch.channels_last)
    assert bn_kernel.row_layout(one) == ((1, 1, 5), (0, 0, 8))
    with pytest.raises(ValueError, match="strides"):
        bn_kernel.row_layout(torch.zeros(2, 8, 6, 5))      # NCHW


def test_conv_input_keeps_the_view_on_the_cpu():
    """`conv_input` changes only the dtype on the CPU: a view of NCHW
    memory (as the augmentations leave a batch) stays one."""
    nchw = torch.zeros(2, 3, 5, 4)
    x = layers.conv_input(nchw.permute(0, 2, 3, 1).permute(0, 3, 1, 2),
                          torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.stride() == nchw.stride()


def test_batch_norm_refuses_a_cpu_tensor():
    bn = layers.BatchNorm(4)
    with pytest.raises(ValueError, match="CUDA"):
        bn_kernel.batch_norm(torch.zeros(3, 4), bn.scale, bn.bias, bn.mean,
                             bn.var, training=True, eps=EPS,
                             momentum=layers.BN_MOMENTUM)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_input(shape, dtype, seed, crop=False):
    """`chip_smoke.k6_inputs`' x; with `crop`, a view of a larger one
    missing its last row and column."""
    if not crop:
        return chip_smoke.k6_inputs(shape, str(dtype)[6:], seed)[0]
    n, c, h, w = shape
    big = chip_smoke.k6_inputs((n, c, h + 1, w + 1), str(dtype)[6:], seed)[0]
    return big[:, :, :h, :w]


def _check_against_float64(shape, dtype, training, seed, crop=False):
    x = _card_input(shape, dtype, seed, crop)
    dy = _card_input(shape, torch.float32, seed + 1)
    C = shape[1]
    ref = chip_smoke.k6_float64(chip_smoke.k6_module(C, seed), x, dy,
                                training)
    kernel, eager = (chip_smoke.k6_run(chip_smoke.k6_module(C, seed), x, dy,
                                       path, training)
                     for path in ("kernel", "eager"))
    report = {}
    for k, want in ref.items():
        floor = 1e-6 * float(want.abs().max())
        err_k = float((kernel[k].double() - want).abs().max())
        err_e = float((eager[k].double() - want).abs().max())
        report[k] = (err_k, err_e)
        assert kernel[k].dtype == eager[k].dtype, k
        assert err_k <= 2 * err_e + floor, (k, report)
    return report


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype", [
    ((256, 64, 96, 96), torch.bfloat16),     # the stem, layer 1
    ((256, 512, 12, 12), torch.bfloat16),    # layer 4
    (MLP_SHAPE, torch.float32)])             # banana's MLP
def test_card_kernels_match_the_eager_chain(card, shape, dtype):
    _check_against_float64(shape, dtype, True, seed=11)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape,crop", [((5, 64, 9, 7), False),
                                        ((5, 64, 9, 7), True),
                                        ((5, 13, 9, 7), False),
                                        ((5, 13, 9, 7), True),
                                        ((37, 13), False)])
def test_card_small_shapes_modes_and_layouts(card, dtype, training, shape,
                                             crop):
    _check_against_float64(shape, dtype, training, seed=12, crop=crop)


@pytest.mark.card
def test_card_two_calls_bit_equal_and_launch_counts(card):
    shape = (64, 128, 24, 24)
    x = _card_input(shape, torch.bfloat16, 13)
    dy = _card_input(shape, torch.float32, 14)
    before = dict(bn_kernel.LAUNCHES)
    runs = [chip_smoke.k6_run(chip_smoke.k6_module(128, 13), x, dy, "kernel")
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in bn_kernel.LAUNCHES.items()} == {
        "batchnorm": 2, "batchnorm_bwd": 2}
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.card
def test_card_refuses_channels_not_innermost(card):
    bn = chip_smoke.k6_module(8, 15)
    x = torch.zeros(2, 8, 5, 5, device="cuda")       # NCHW
    with pytest.raises(ValueError, match="strides"):
        bn(x, training=True)
    with pytest.raises(ValueError, match="float32"):
        bn(x.to(torch.float16).contiguous(memory_format=torch.channels_last),
           training=True)


@pytest.mark.card
def test_card_world_of_one_bit_equal_to_no_group(card):
    """Inside `data_parallel` in a process group of one NCCL rank the
    statistics and gradient sums go through `mesh.all_reduce_sum`: every
    output equals the call without a group bit for bit."""
    import torch.distributed as dist

    from lossyless_tpu_torch.core import mesh

    shape = (32, 64, 12, 12)
    x = _card_input(shape, torch.bfloat16, 16)
    dy = _card_input(shape, torch.float32, 17)
    alone = chip_smoke.k6_run(chip_smoke.k6_module(64, 16), x, dy, "kernel")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{mesh.free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        calls = []
        real = mesh.all_reduce_sum

        def counted(t):
            calls.append(tuple(t.shape))
            return real(t)

        mesh.all_reduce_sum = counted
        try:
            with mesh.data_parallel(0, 1, shape[0]):
                grouped = chip_smoke.k6_run(chip_smoke.k6_module(64, 16), x,
                                            dy, "kernel")
        finally:
            mesh.all_reduce_sum = real
    finally:
        dist.destroy_process_group()
    assert calls == [(2, 64), (2, 64)]
    for k in alone:
        assert torch.equal(alone[k], grouped[k]), k
    np.testing.assert_array_equal(alone["y"].cpu().numpy(),
                                  grouped["y"].cpu().numpy())


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype", [
    ((64, 16, 12, 12), torch.float32), ((2048, 16), torch.float32)])
def test_card_clamped_channel_against_the_plain_backward(card, shape, dtype):
    """Channel 0 held at a constant whose fast variance K6's own fp32 sums
    make negative: the clamp binds there (flag 0, rstd = eps^-1/2, no
    gradient through the variance), and K6's dx, dscale and dbias equal
    `batchnorm_backward_plain` in float64 fed K6's own statistics; every
    other channel's flag, mean and rstd are float64's. fp32 input: a bf16
    constant has 8 significant bits, and over these row counts its sums
    are exact, E[x^2] - E[x]^2 = 0, so the clamp never binds there (the
    statistics and the clamp are the same code for both input dtypes)."""
    C = shape[1]
    bn = chip_smoke.k6_module(C, 21)
    base, dy = chip_smoke.k6_inputs(shape, str(dtype)[6:], 21)
    for i in range(1, 400):
        x = base.clone()
        x[:, 0] = i / 97
        xi = x.requires_grad_()
        y = bn(xi, training=True)
        stats = y.grad_fn.saved_tensors[2]    # mean, rstd, clamp flag
        if stats[2, 0] == 0:
            break
    else:
        raise AssertionError("no constant makes K6's fast variance negative")
    bn.zero_grad()
    y.backward(dy)
    want = bn_kernel.batchnorm_backward_plain(
        x.detach().double(), dy.double(), bn.scale.detach().double(),
        stats.double(), True)
    for got, w, tol in zip((xi.grad, bn.scale.grad, bn.bias.grad), want,
                           (dtype, torch.float32, torch.float32)):
        _close(got.double(), w, tol)
    f64 = _forward_stats(x.detach().double())
    assert bool((stats[2, 1:] == 1).all()) and bool((f64[2, 1:] == 1).all())
    _close(stats[:2, 1:].double(), f64[:2, 1:], torch.float32)
    torch.testing.assert_close(float(stats[1, 0]), EPS ** -0.5, rtol=1e-6,
                               atol=0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_world_of_two_equals_the_doubled_batch(card, dtype, monkeypatch):
    """A data-parallel world of two whose other rank holds the same rows
    (`mesh.active()` says world 2, `mesh.all_reduce_sum` returns 2 t): y,
    the running statistics and dx equal a call without a group on the
    batch [x; x] (its first half); dscale and dbias are half of that
    call's (the rank's share, which the step's gradient all-reduce
    sums)."""
    from lossyless_tpu_torch.core import mesh

    shape = (32, 64, 12, 12)
    x, dy = chip_smoke.k6_inputs(shape, str(dtype)[6:], 22)
    doubled = [torch.cat([t, t]).contiguous(memory_format=torch.channels_last)
               for t in (x, dy)]
    whole = chip_smoke.k6_run(chip_smoke.k6_module(64, 22), *doubled,
                              "kernel")
    calls = []

    def twice(t):
        calls.append(tuple(t.shape))
        return 2 * t

    monkeypatch.setattr(mesh, "active", lambda: (0, 2, shape[0], 1))
    monkeypatch.setattr(mesh, "all_reduce_sum", twice)
    rank = chip_smoke.k6_run(chip_smoke.k6_module(64, 22), x, dy, "kernel")
    monkeypatch.undo()
    assert calls == [(2, 64), (2, 64)]
    n = shape[0]
    pairs = dict(y=(rank["y"], whole["y"][:n]),
                 dx=(rank["dx"], whole["dx"][:n]),
                 dscale=(2 * rank["dscale"], whole["dscale"]),
                 dbias=(2 * rank["dbias"], whole["dbias"]),
                 mean=(rank["mean"], whole["mean"]),
                 var=(rank["var"], whole["var"]))
    for k, (got, want) in pairs.items():
        assert got.dtype == want.dtype, k
        _close(got.double(), want.double(), got.dtype)


@pytest.mark.card
def test_card_resnet_takes_a_batch_in_nchw_memory(card):
    """A batch that is an NHWC view of NCHW memory (the augmentations'
    resampling leaves it so) runs ResNet-18 on K6: `conv_input` makes the
    channels innermost, every BatchNorm input keeps them there, one launch
    a BatchNorm each way."""
    from lossyless_tpu_torch.nn.resnet import ResNet

    net = ResNet(16, (32, 32, 3), "resnet18", dtype="bfloat16").cuda()
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn(8, 3, 32, 32, generator=g, device="cuda").permute(
        0, 2, 3, 1)
    before = dict(bn_kernel.LAUNCHES)
    net(x, training=True).square().sum().backward()
    torch.cuda.synchronize()
    n_bn = sum(isinstance(m, layers.BatchNorm) for m in net.modules())
    assert {k: v - before[k] for k, v in bn_kernel.LAUNCHES.items()} == {
        "batchnorm": n_bn, "batchnorm_bwd": n_bn}
