"""BatchNorm's forward and backward (CUDA, Hopper): K6.

`batch_norm(x, scale, bias, running, ...)` is flax's `nn.BatchNorm`
(`nn/layers.py::BatchNorm`) on a CUDA tensor: the channels on dim 1 and
innermost in memory (a `channels_last` 4-D tensor, or a (B, C) matrix), x
bf16 or fp32, fp32 arithmetic and an fp32 output, flax's fast variance
E[x^2] - E[x]^2 clamped at 0; its backward is a kernel pair too. Both are
CUDA C++ in `csrc/batchnorm.cu` (design and bound noted there), built with
nvcc at first use (`_build.py`) and called through ctypes on PyTorch's
current stream. The wrapper checks device, dtype, shape and layout of x and
of the parameters and running statistics (fp32, contiguous, (C,), x's
device), takes the launch geometry from `bn_plan`, launches, raises if a
launch returned a CUDA error, and adds one to `LAUNCHES` a forward and one
a backward.

Training: the per-channel sums (two launches), then the normalize kernel,
which also writes the running statistics in place (one). Inside a
data-parallel step (`core.mesh.active()`) the (2, C) sums go through
`mesh.all_reduce_sum` between the two: forward each rank's E[x] and E[x^2]
(divided by the world size in the kernel, as `layers._batch_stats` does),
backward the rank's gradient sums for the statistics' terms (as autograd
of the all-reduce gives them); in a world of one each is an identity.

A CPU tensor never comes here: `BatchNorm` keeps its eager chain there.
`batchnorm_backward_plain` is the analytic VJP in tensor ops, the
reference the backward kernels are held to; it takes the forward's
statistics as the Function saves them (mean, rstd, clamp flag).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from ..core import mesh
from ..core.profiling import span

LAUNCHES = {"batchnorm": 0, "batchnorm_bwd": 0}

# The kernels' compile-time geometry (batchnorm.cu; the library's own
# values are checked against these once, at load)
THREADS = 256        # threads a block of the row kernels
LANES = 32           # threads a block along the channels, at most
MAX_VEC = 8          # channels a thread owns, at most (16 bytes of bf16)
FINAL = (32, 32)     # the finalize kernel's block: sums x tile lanes
RED_SMEM = 4 * 2 * THREADS * MAX_VEC   # the partial kernel's shared memory
MAX_SMEM = 232448    # shared memory a block may use (227 KB)
INT_MAX = 2**31 - 1  # rows and C are C ints
MAX_TILES = 65535    # grid.y
RESIDENT = 3         # blocks of a row kernel an SM holds at once, at least
SMS = 132            # an H100 SXM's SMs, unless the plan is given others
MIN_SWEEPS = 8       # rows a thread walks in its tile, at least
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class BNPlan:
    """Launch geometry of K6's row kernels (`batchnorm.cu`).

    A block owns `rows_per_tile` rows x one slice of `tc * vec` channels:
    `tc` threads along the channels, each owning `vec` of them (16 bytes
    of x, else 1), `tr` along the rows. The grid is `slices` x `tiles`;
    the reductions keep one (2, C) slot a tile (`scratch_floats` in all)
    and the finalize sums the tiles in a fixed order."""
    rows: int
    C: int
    dtype: str
    vec: int
    tc: int
    tr: int
    slices: int
    rows_per_tile: int
    tiles: int

    @property
    def smem(self) -> int:
        """Shared memory the partial kernel's block sums use."""
        return 4 * 2 * self.tr * self.tc * self.vec

    @property
    def scratch_floats(self) -> int:
        return self.tiles * 2 * self.C


@functools.lru_cache(maxsize=1024)
def bn_plan(rows: int, C: int, dtype: str, aligned: bool = True,
            sms: int = SMS) -> BNPlan:
    """K6's geometry for x (rows, C) of `dtype` ("bfloat16" or "float32").

    `aligned`: x's pointer and row strides allow 16-byte loads (the
    wrapper's check); then a thread owns 16 bytes of channels where C
    allows it, else one channel. At most LANES threads go along the
    channels and the rest of THREADS along the rows; the rows are cut into
    equal tiles so that the grid is at most one wave of RESIDENT blocks an
    SM (every block runs from the start, none waits for a tail), each
    thread walking at least MIN_SWEEPS rows of its tile. Raises on 1 <= rows, C <= INT_MAX not holding or an
    unknown dtype."""
    if dtype not in ITEMSIZE:
        raise ValueError(f"K6 takes x in {sorted(ITEMSIZE)}, got {dtype}")
    if not 1 <= rows <= INT_MAX or not 1 <= C <= INT_MAX:
        raise ValueError(f"rows={rows} and C={C} must be in 1..{INT_MAX}")
    wide = 16 // ITEMSIZE[dtype]
    vec = wide if aligned and C % wide == 0 else 1
    tc = min(LANES, -(-C // vec))
    tr = THREADS // tc
    slices = -(-C // (tc * vec))
    wave = max(1, RESIDENT * sms // slices)
    tiles = max(1, min(-(-rows // (tr * MIN_SWEEPS)), wave, MAX_TILES))
    rows_per_tile = -(-(-(-rows // tiles)) // tr) * tr
    tiles = -(-rows // rows_per_tile)
    return BNPlan(rows, C, dtype, vec, tc, tr, slices, rows_per_tile, tiles)


def row_layout(x: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(sizes, strides) of x's rows over three dims, outer to inner: every
    dim but the channels' (1), in order, size-1 dims dropped and neighbours
    that are one run merged, padded in front with (1, 0). Raises where the
    channels are not innermost (stride 1) or the rows need more dims."""
    C = x.shape[1]
    if C > 1 and x.stride(1) != 1:
        raise ValueError(f"K6 needs the channels (dim 1) innermost, got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")
    runs: list[list[int]] = []
    for d in (0, *range(2, x.dim())):
        n, s = x.shape[d], x.stride(d)
        if n == 1:
            continue
        if runs and runs[-1][1] == n * s:
            runs[-1] = [runs[-1][0] * n, s]
        else:
            runs.append([n, s])
    if len(runs) > 3:
        raise ValueError(f"K6 takes rows over at most 3 strided dims, got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")
    runs = [[1, 0]] * (3 - len(runs)) + runs
    return tuple(n for n, _ in runs), tuple(s for _, s in runs)


def batchnorm_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                             scale: torch.Tensor, stats: torch.Tensor,
                             training: bool):
    """Plain K6 backward: the VJP of `BatchNorm`'s forward at x (channels
    on dim 1) for the cotangent dy, given the forward's stats (3, C): mean,
    rstd, clamp flag. Returns (dx in x's dtype, dscale, dbias), computed in
    dy's dtype.

    dbias = S1 = sum dy, dscale = S2 = sum dy xhat over every dim but the
    channels'; dx = scale rstd dy, plus in training mode the gradient
    through E[x] and E[x^2] (n rows): K0 = -rstd scale S1 / n and K1 (x -
    mean) with K1 = 2 gvar / n, gvar = -rstd^2 scale S2 / 2 times the
    clamp flag."""
    dims = (0,) + tuple(range(2, x.dim()))
    n = x.numel() // x.shape[1]

    def per(v):
        return v.reshape((-1,) + (1,) * (x.dim() - 2))

    xf = x.to(dy.dtype)
    mean, rstd, live = stats.to(dy.dtype)
    centred = xf - per(mean)
    s1 = dy.sum(dims)
    s2 = (dy * (centred * per(rstd))).sum(dims)
    dx = per(scale * rstd) * dy
    if training:
        gvar = -0.5 * rstd * rstd * scale * s2 * live
        dx = dx + per(-rstd * scale * s1 / n) + per(2 * gvar / n) * centred
    return dx.to(x.dtype), s2, s1


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


class _Geometry(ctypes.Structure):
    """`Geometry` of batchnorm.cu."""
    _fields_ = [("rows", ctypes.c_longlong), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong), ("s2", ctypes.c_longlong),
                *((f, ctypes.c_int) for f in (
                    "d1", "d2", "C", "dtype", "vec", "dense", "tc", "tr",
                    "rows_per_tile", "tiles", "slices"))]


class _Norm(ctypes.Structure):
    """`Norm` of batchnorm.cu."""
    _fields_ = [("world", ctypes.c_float), ("eps", ctypes.c_float),
                ("momentum", ctypes.c_float),
                ("one_minus_momentum", ctypes.c_float),
                ("training", ctypes.c_int)]


_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from . import _build

                lib = _build.load("batchnorm")
                i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
                lib.lossyless_bn_geometry.restype = None
                lib.lossyless_bn_geometry.argtypes = [ctypes.POINTER(i)]
                lib.lossyless_bn_stats.restype = i
                lib.lossyless_bn_stats.argtypes = [p, _Geometry, p, p, p]
                lib.lossyless_bn_normalize.restype = i
                lib.lossyless_bn_normalize.argtypes = [
                    p, p, p, p, p, p, p, p, _Geometry, _Norm, p]
                lib.lossyless_bn_grad_sums.restype = i
                lib.lossyless_bn_grad_sums.argtypes = [
                    p, p, p, _Geometry, p, p, p]
                lib.lossyless_bn_dx.restype = i
                lib.lossyless_bn_dx.argtypes = [
                    p, p, p, p, p, p, _Geometry, f, i, p]
                got = (i * 7)()
                lib.lossyless_bn_geometry(got)
                want = (THREADS, LANES, MAX_VEC, *FINAL, RED_SMEM, RESIDENT)
                if tuple(got) != want:
                    raise RuntimeError(f"batchnorm library geometry "
                                       f"{tuple(got)} != the plan's {want}")
                _lib = lib
    return _lib


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


@dataclass(frozen=True)
class _Call:
    """What both directions of one call launch with."""
    plan: BNPlan
    geometry: _Geometry
    shape: tuple     # x's shape with the channels last (y's and dx's)
    training: bool
    world: int | None   # a training call's data-parallel world, else None


def _prepare(x: torch.Tensor, training: bool) -> _Call:
    if x.device.type != "cuda":
        raise ValueError(f"K6 needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"K6 takes x in bfloat16 or float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"K6 needs x with channels on dim 1, got shape "
                         f"{tuple(x.shape)}")
    C = x.shape[1]
    rows = x.numel() // C if C else 0
    (_, d1, d2), (s0, s1, s2) = row_layout(x)
    dtype = str(x.dtype).removeprefix("torch.")
    wide = 16 // ITEMSIZE[dtype]
    aligned = x.data_ptr() % 16 == 0 and all(
        s % wide == 0 for s in (s0, s1, s2))
    plan = bn_plan(rows, C, dtype, aligned, _sm_count(x.device))
    dense = (d1, d2, s2) == (1, rows, C) or rows == 1
    dp = mesh.active()
    return _Call(plan, _Geometry(rows, s0, s1, s2, d1, d2, C,
                                 DTYPES[x.dtype], plan.vec, int(dense),
                                 plan.tc, plan.tr, plan.rows_per_tile,
                                 plan.tiles, plan.slices),
                 (x.shape[0], *x.shape[2:], C), training,
                 dp[1] if training and dp is not None else None)


def _check_vector(t: torch.Tensor, name: str, x: torch.Tensor):
    if t.device != x.device or t.dtype != torch.float32 \
            or tuple(t.shape) != (x.shape[1],) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 ({x.shape[1]},) "
                         f"tensor on {x.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _dense_rows(dy: torch.Tensor, call: _Call) -> torch.Tensor:
    """dy as a dense (rows, C) fp32 tensor, 16-byte aligned (a copy only
    where the gradient arrives in another layout)."""
    rows = call.plan.rows
    d = dy.movedim(1, -1).float().contiguous().view(rows, call.plan.C)
    return d if d.data_ptr() % 16 == 0 else d.clone()


def _scratch(plan: BNPlan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reductions' (tiles, 2, C) partials and (2, C) sums."""
    return (torch.empty(plan.scratch_floats, device=device,
                        dtype=torch.float32),
            torch.empty(2, plan.C, device=device, dtype=torch.float32))


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, running, eps, momentum, call):
        lib = _get_lib()
        plan, g = call.plan, call.geometry
        stream = torch.cuda.current_stream(x.device).cuda_stream
        y = torch.empty(call.shape, device=x.device, dtype=torch.float32)
        stats = torch.empty(3, plan.C, device=x.device, dtype=torch.float32)
        sums = None
        with torch.cuda.device(x.device):
            if call.training:
                partials, sums = _scratch(plan, x.device)
                _rc(lib.lossyless_bn_stats(x.data_ptr(), g,
                                           partials.data_ptr(),
                                           sums.data_ptr(), stream),
                    "batchnorm stats")
                if call.world is not None:
                    sums = mesh.all_reduce_sum(sums)
            run_mean, run_var = running
            _rc(lib.lossyless_bn_normalize(
                x.data_ptr(), y.data_ptr(),
                None if sums is None else sums.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), run_mean.data_ptr(), run_var.data_ptr(),
                stats.data_ptr(), g,
                _Norm(call.world or 1, eps, momentum, 1 - momentum,
                      int(call.training)), stream), "batchnorm")
        LAUNCHES["batchnorm"] += 1
        ctx.call = call
        ctx.save_for_backward(x, scale, stats)
        return y.movedim(-1, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, scale, stats = ctx.saved_tensors
        call = ctx.call
        want_x, want_scale, want_bias = ctx.needs_input_grad[:3]
        plan, g = call.plan, call.geometry
        lib = _get_lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dx = sums = None
        with span("nn.batchnorm.backward"), torch.cuda.device(x.device):
            dy = _dense_rows(dy, call)
            if call.training or want_scale or want_bias:
                partials, sums = _scratch(plan, x.device)
                _rc(lib.lossyless_bn_grad_sums(
                    x.data_ptr(), dy.data_ptr(), stats.data_ptr(), g,
                    partials.data_ptr(), sums.data_ptr(), stream),
                    "batchnorm_bwd sums")
            if want_x:
                summed = sums
                if call.world is not None:
                    summed = mesh.all_reduce_sum(sums)
                dx = torch.empty(call.shape, device=x.device, dtype=x.dtype)
                _rc(lib.lossyless_bn_dx(
                    x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    None if summed is None else summed.data_ptr(),
                    stats.data_ptr(), scale.data_ptr(), g,
                    plan.rows * (call.world or 1), int(call.training),
                    stream), "batchnorm_bwd")
                dx = dx.movedim(-1, 1)
        LAUNCHES["batchnorm_bwd"] += 1
        return (dx, sums[1] if want_scale else None,
                sums[0] if want_bias else None, None, None, None, None)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               training: bool, eps: float, momentum: float) -> torch.Tensor:
    """K6: `BatchNorm`'s forward on a CUDA tensor x (channels on dim 1 and
    innermost in memory; bf16 or fp32); y fp32 in x's shape, channels
    innermost. Training updates `running_mean` / `running_var` in place
    (`momentum` of the old value kept). Every other tensor fp32, contiguous,
    (C,) and on x's device; otherwise, and for a CPU x, raises."""
    call = _prepare(x, training)
    for t, name in ((scale, "scale"), (bias, "bias"),
                    (running_mean, "running mean"),
                    (running_var, "running var")):
        _check_vector(t, name, x)
    return _BatchNorm.apply(x, scale, bias, (running_mean, running_var),
                            eps, momentum, call)
