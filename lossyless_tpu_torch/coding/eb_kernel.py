"""Fused factorized-prior likelihood and its gradient (CUDA, Hopper): K3.

Counterpart of `lossyless_tpu/coding/pallas_eb.py`. `likelihood(params, z)`
returns the entropy bottleneck's likelihood of `z` (batch, channels),
floored at `LIKELIHOOD_BOUND` inside the kernel, as `pallas_eb.likelihood`
does; its backward is a kernel too. Both are CUDA C++ in
`csrc/eb_likelihood.cu` (design and bound noted there), built with nvcc at
first use (`nn/_build.py`) and called through ctypes on PyTorch's current
stream. The kernels read the parameter tensors where they lie, through a
table of pointers in the order of JAX's `pack_weights` (`param_slots`);
nothing is packed per call. The wrapper checks device, dtype, shape and
contiguity of z and of every parameter (fp32, contiguous, one device),
takes the launch geometry from `k3_plan`, launches, raises if the launch
returned a CUDA error, and adds one to `LAUNCHES`.

A CPU tensor goes to the plain versions: `likelihood_plain` (the port's
`entropy_bottleneck.likelihood` floored with `clamp_min`) forward and
`likelihood_backward_plain` (the analytic VJP of the JAX `custom_vjp`'s
backward, `pallas_eb.py:153-171`, written out in tensor ops) backward. A
CUDA tensor goes to the kernels or the call raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.math import lower_bound
from . import entropy_bottleneck as eb

LAUNCHES = {"eb_likelihood": 0, "eb_likelihood_bwd": 0}

# The kernels' compile-time geometry (eb_likelihood.cu; the library's own
# values are checked against these once, at load)
CHANNELS = 32        # channels a block: one a lane
SPLIT = 8            # blocks a cluster, splitting the batch rows
WARPS = 8            # warps a block, at most
MAX_WIDTH = 8        # widest filter
MAX_LAYERS = 8       # layers of the chain (filters + 1)
MAX_SMEM = 232448    # dynamic shared memory a block may use (227 KB)
INT_MAX = 2**31 - 1  # B and C are C ints
# filter tuples whose chain is compiled as a fixed shape, by design id;
# others run the generic chain (unrolled to MAX_WIDTH)
FIXED = {(3, 3, 3, 3): 0, (3, 3, 3): 1}
GENERIC = 2


def n_coeffs(widths: tuple[int, ...]) -> int:
    """Coefficients a channel, in `pack_weights` order: each layer's
    matrix (out x in) and bias, and its factor but for the last layer."""
    L = len(widths) - 1
    return sum(o * i + o + (o if l < L - 1 else 0)
               for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])))


@dataclass(frozen=True)
class K3Plan:
    """Launch geometry of K3 and its backward (`eb_likelihood.cu`).

    `design` names the compiled chain (`fixed(3, 3, 3, 3)`,
    `fixed(3, 3, 3)`, `generic`) and `design_id` its id in
    the library. `blocks` = clusters of SPLIT blocks, one cluster a group
    of CHANNELS channels; each block keeps `smem` bytes of its channels'
    transformed coefficients; the backward keeps one (K, CHANNELS) slab of
    gradient sums a warp beside them (`bwd_smem`). Each kernel takes the
    most warps a block, at most WARPS (and, for the backward, as many as
    fit in MAX_SMEM), with which the card holds all the call's clusters
    at once: a cluster left for a second wave costs a whole pass."""
    design: str
    design_id: int
    widths: tuple[int, ...]
    n_coeffs: int
    blocks: int
    threads: int
    smem: int
    bwd_threads: int
    bwd_smem: int


@functools.lru_cache(maxsize=256)
def k3_plan(B: int, C: int, widths: tuple[int, ...],
            resident: tuple | None = None) -> K3Plan:
    """K3's design and geometry for z (B, C) and widths (1, filters..., 1).

    `resident` = (forward, backward): for 1..WARPS warps a block, how many
    clusters of the design's kernel the card holds at once (`_resident`,
    queried once per device); None takes every count as enough. The real
    limits, all raised here: 1 <= B, C <= INT_MAX; 1 to MAX_LAYERS layers;
    every filter 1 to MAX_WIDTH wide. The shared memory then always fits:
    the widest chain's table is 65,664 bytes and its backward keeps two
    warps."""
    widths = tuple(widths)
    if not 1 <= B <= INT_MAX or not 1 <= C <= INT_MAX:
        raise ValueError(f"B={B} and C={C} must be in 1..{INT_MAX}")
    L = len(widths) - 1
    if not 1 <= L <= MAX_LAYERS or widths[0] != 1 or widths[-1] != 1:
        raise ValueError(f"widths {widths} must be (1, filters..., 1) with "
                         f"at most {MAX_LAYERS} layers")
    if not all(1 <= w <= MAX_WIDTH for w in widths):
        raise ValueError(f"filter widths {widths[1:-1]} exceed the kernel's "
                         f"{MAX_WIDTH} filters x {MAX_LAYERS} layers")
    filters = widths[1:-1]
    if filters in FIXED:
        design, design_id = f"fixed{filters}", FIXED[filters]
    else:
        design, design_id = "generic", GENERIC
    K = n_coeffs(widths)
    table = 4 * K * CHANNELS
    clusters = -(-C // CHANNELS)

    def warps(most: int, held) -> int:
        return next((w for w in range(most, 0, -1)
                     if held is None or held[w - 1] >= clusters), most)

    fwd, bwd = resident or (None, None)
    bwd_warps = warps(min(WARPS, MAX_SMEM // table - 1), bwd)
    return K3Plan(design, design_id, widths, K, blocks=clusters * SPLIT,
                  threads=warps(WARPS, fwd) * CHANNELS, smem=table,
                  bwd_threads=bwd_warps * CHANNELS,
                  bwd_smem=(1 + bwd_warps) * table)


def param_slots(params: dict) -> tuple[tuple[int, str], ...]:
    """(slot, name) of every chain parameter, in `pack_weights` order:
    slot 3 l holds matrix{l}, 3 l + 1 bias{l}, 3 l + 2 factor{l} (all but
    the last layer)."""
    return _slots(eb.n_layers(params))


@functools.lru_cache(maxsize=MAX_LAYERS + 1)
def _slots(L: int) -> tuple[tuple[int, str], ...]:
    return tuple((3 * l + kind, f"{name}{l}") for l in range(L)
                 for kind, name in enumerate(("matrix", "bias", "factor"))
                 if kind < 2 or l < L - 1)


def widths(params: dict) -> tuple[int, ...]:
    """(1, filters..., 1) of an entropy-bottleneck param dict."""
    L = eb.n_layers(params)
    return (1,) + tuple(params[f"matrix{i}"].shape[1] for i in range(L))


def check_params(params: dict, z: torch.Tensor) -> K3Plan:
    """The plan for z (B, C) after checking what the kernels take: every
    chain parameter fp32, contiguous, on z's device and shaped
    (C, out, in) / (C, out, 1) for widths (1, filters..., 1). On a CUDA
    device the plan counts the clusters the card holds at once."""
    if z.dim() != 2:
        raise ValueError(f"z must be (batch, channels), got {tuple(z.shape)}")
    B, C = z.shape
    slots = _slots(eb.n_layers(params))
    w = (1,) + tuple(params[name].shape[1] for slot, name in slots
                     if slot % 3 == 0)
    for slot, name in slots:
        t = params[name]
        l = slot // 3
        shape = (C, w[l + 1], w[l] if slot % 3 == 0 else 1)
        if t.device != z.device:
            raise ValueError(f"z and params must all be on the CPU or all on "
                             f"a CUDA device (one): {name} on {t.device}, z "
                             f"on {z.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    plan = k3_plan(B, C, w)
    if z.device.type == "cuda":
        plan = k3_plan(B, C, w, _resident(z.device, plan))
    return plan


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def likelihood_plain(params: dict, z: torch.Tensor) -> torch.Tensor:
    """Plain K3: the reference chain, floored at the bound (the kernel's
    forward arithmetic, `pallas_eb.py:99-103`)."""
    return eb.likelihood(params, z).clamp_min(eb.LIKELIHOOD_BOUND)


def likelihood_backward_plain(params: dict, z: torch.Tensor,
                              g: torch.Tensor):
    """Plain K3 backward: the VJP of `likelihood` at z (batch, channels)
    for the cotangent g, written out over the (channels, batch) layout.

    The chain rule of the JAX `_bwd` (`pallas_eb.py:153-171`): lower_bound
    passes g where the raw likelihood is >= the bound or g < 0; the sign
    s = -sign(lower + upper) is held constant; d|D| = +1 for D >= 0 and
    -1 below, JAX's derivative of `abs` (1 at D = 0, where the upper and
    lower sigmoids round to one value while their slopes are not 0);
    d softplus = sigmoid, d tanh = 1 - tanh^2. Returns (dz (batch, channels), a dict
    of gradients shaped like the chain parameters)."""
    L = eb.n_layers(params)
    A = [F.softplus(params[f"matrix{l}"]) for l in range(L)]
    b = [params[f"bias{l}"] for l in range(L)]
    T = [torch.tanh(params[f"factor{l}"]) for l in range(L - 1)]

    def chain(x):
        ins, ths = [], []
        for l in range(L):
            ins.append(x)
            x = torch.matmul(A[l], x) + b[l]
            if l < L - 1:
                ths.append(torch.tanh(x))
                x = x + T[l] * ths[-1]
        return x, ins, ths

    v = z.float().transpose(0, 1)[:, None, :]          # (C, 1, B)
    lower, lo_ins, lo_ths = chain(v - 0.5)
    upper, up_ins, up_ths = chain(v + 0.5)
    s = -torch.sign(lower + upper)
    pu, pl = torch.sigmoid(s * upper), torch.sigmoid(s * lower)
    delta = pu - pl
    gv = g.float().transpose(0, 1)[:, None, :]
    gv = torch.where((delta.abs() >= eb.LIKELIHOOD_BOUND) | (gv < 0), gv,
                     torch.zeros_like(gv))
    gd = torch.where(delta >= 0, gv, -gv)
    grads = {}

    def back(gx, ins, ths):
        for l in reversed(range(L)):
            if l < L - 1:
                th = ths[l]
                gt = (gx * th).sum(-1, keepdim=True)
                grads[f"factor{l}"] = grads.get(f"factor{l}", 0) + gt
                gx = gx + gx * T[l] * (1 - th * th)
            grads[f"bias{l}"] = grads.get(f"bias{l}", 0) + gx.sum(
                -1, keepdim=True)
            grads[f"matrix{l}"] = grads.get(f"matrix{l}", 0) + torch.matmul(
                gx, ins[l].transpose(-1, -2))
            gx = torch.matmul(A[l].transpose(-1, -2), gx)
        return gx

    dz = back(-gd * pl * (1 - pl) * s, lo_ins, lo_ths) \
        + back(gd * pu * (1 - pu) * s, up_ins, up_ths)
    for l in range(L):
        grads[f"matrix{l}"] = grads[f"matrix{l}"] * torch.sigmoid(
            params[f"matrix{l}"])
        if l < L - 1:
            grads[f"factor{l}"] = grads[f"factor{l}"] * (1 - T[l] * T[l])
    return dz[:, 0, :].transpose(0, 1), grads


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """`Args` of eb_likelihood.cu: the parameters' and gradients' pointers
    by slot, the number of layers and the widths padded with 1."""
    _fields_ = [("param", ctypes.c_void_p * (3 * MAX_LAYERS)),
                ("grad", ctypes.c_void_p * (3 * MAX_LAYERS)),
                ("n_layers", ctypes.c_int),
                ("width", ctypes.c_int * (MAX_LAYERS + 1))]


_lib = None
_lib_lock = threading.Lock()
_ready_devices: set[int] = set()


def _get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from ..nn import _build

                lib = _build.load("eb_likelihood")
                i, p, n = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
                lib.lossyless_eb_geometry.restype = None
                lib.lossyless_eb_geometry.argtypes = [ctypes.POINTER(i)]
                lib.lossyless_eb_init.restype = i
                lib.lossyless_eb_init.argtypes = []
                lib.lossyless_eb_likelihood.restype = i
                lib.lossyless_eb_likelihood.argtypes = [
                    p, p, i, i, i, i, n, _Args, p]
                lib.lossyless_eb_likelihood_bwd.restype = i
                lib.lossyless_eb_likelihood_bwd.argtypes = [
                    p, p, p, i, i, i, i, n, _Args, p]
                lib.lossyless_eb_resident_clusters.restype = i
                lib.lossyless_eb_resident_clusters.argtypes = [i, i, i, n]
                got = (i * 6)()
                lib.lossyless_eb_geometry(got)
                want = (CHANNELS, SPLIT, WARPS, MAX_WIDTH, MAX_LAYERS,
                        MAX_SMEM)
                if tuple(got) != want:
                    raise RuntimeError(f"eb_likelihood library geometry "
                                       f"{tuple(got)} != the plan's {want}")
                _lib = lib
    return _lib


def _prepared(device: torch.device):
    """The library, set up once for the device (its shared-memory limit)."""
    lib = _get_lib()
    if device.index not in _ready_devices:
        with torch.cuda.device(device):
            rc = lib.lossyless_eb_init()
        if rc != 0:
            raise RuntimeError(f"eb_likelihood init failed: CUDA error {rc}")
        _ready_devices.add(device.index)
    return lib


_resident_by_device: dict = {}


def _resident(device: torch.device, plan: K3Plan) -> tuple:
    """For `k3_plan`: how many clusters of the plan's design the card holds
    at once, forward and backward, at 1..WARPS warps a block (queried once
    per device, design and coefficient count)."""
    key = (device.index, plan.design_id, plan.n_coeffs)
    if key not in _resident_by_device:
        lib = _prepared(device)
        most = MAX_SMEM // plan.smem - 1   # backward warps that fit
        with torch.cuda.device(device):
            held = tuple(tuple(
                lib.lossyless_eb_resident_clusters(
                    plan.design_id, bwd, w * CHANNELS,
                    (1 + w) * plan.smem if bwd else plan.smem)
                if not bwd or w <= most else 0
                for w in range(1, WARPS + 1)) for bwd in (0, 1))
        if min(held[0]) < 0 or min(held[1]) < 0:
            raise RuntimeError(f"eb_likelihood occupancy query failed: {held}")
        _resident_by_device[key] = held
    return _resident_by_device[key]


def _args(params: dict, plan: K3Plan, grads: dict | None = None) -> _Args:
    a = _Args()
    for slot, name in _slots(len(plan.widths) - 1):
        a.param[slot] = params[name].data_ptr()
        if grads is not None:
            a.grad[slot] = grads[name].data_ptr()
    a.n_layers = len(plan.widths) - 1
    a.width[:] = plan.widths + (1,) * (MAX_LAYERS + 1 - len(plan.widths))
    return a


def _check_z(t: torch.Tensor, name: str = "z"):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor, got "
                         f"{t.dtype}, strides {t.stride()}")


def _launch(params: dict, z: torch.Tensor, plan: K3Plan) -> torch.Tensor:
    _check_z(z)
    lib = _prepared(z.device)
    out = torch.empty_like(z)
    B, C = z.shape
    with torch.cuda.device(z.device):
        rc = lib.lossyless_eb_likelihood(
            z.data_ptr(), out.data_ptr(), B, C, plan.design_id, plan.threads,
            plan.smem, _args(params, plan),
            torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eb_likelihood kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["eb_likelihood"] += 1
    return out


def _launch_bwd(params: dict, z: torch.Tensor, g: torch.Tensor,
                plan: K3Plan, want_z: bool, want_params: bool):
    """dz (or None) and the parameter gradients by name (or None)."""
    _check_z(z)
    _check_z(g, "g")
    lib = _prepared(z.device)
    dz = torch.empty_like(z) if want_z else None
    grads = ({name: torch.empty_like(params[name])
              for _, name in _slots(len(plan.widths) - 1)}
             if want_params else None)
    B, C = z.shape
    with torch.cuda.device(z.device):
        rc = lib.lossyless_eb_likelihood_bwd(
            z.data_ptr(), g.data_ptr(), None if dz is None else dz.data_ptr(),
            B, C, plan.design_id, plan.bwd_threads, plan.bwd_smem,
            _args(params, plan, grads),
            torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eb_likelihood_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["eb_likelihood_bwd"] += 1
    return dz, grads


def _reference(params: dict, z: torch.Tensor) -> torch.Tensor:
    # eb.likelihood detaches the sign; lower_bound (not clamp) keeps the
    # recover-direction gradient of floored likelihoods
    return lower_bound(eb.likelihood(params, z), eb.LIKELIHOOD_BOUND)


class _EBLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, plan, keys, *values):
        params = dict(zip(keys, values))
        ctx.plan, ctx.keys = plan, keys
        ctx.save_for_backward(z, *values)
        if z.device.type == "cpu":
            return likelihood_plain(params, z)
        return _launch(params, z, plan)

    @staticmethod
    def backward(ctx, g):
        z, *values = ctx.saved_tensors
        params = dict(zip(ctx.keys, values))
        want_z = ctx.needs_input_grad[0]
        want_params = any(ctx.needs_input_grad[3:])
        if not (want_z or want_params):
            return (None,) * (3 + len(values))
        if z.device.type == "cpu":
            dz, grads = likelihood_backward_plain(params, z, g)
        else:
            dz, grads = _launch_bwd(params, z, g.contiguous(), ctx.plan,
                                    want_z, want_params)
        out_v = [grads[k] if grads is not None and need and k in grads
                 else None
                 for k, need in zip(ctx.keys, ctx.needs_input_grad[3:])]
        return (dz if want_z else None, None, None, *out_v)


def likelihood(params: dict, z: torch.Tensor) -> torch.Tensor:
    """K3: likelihood of z (batch, channels) fp32, floored at the bound.

    Only the chain's params (`matrix*`, `bias*`, `factor*`) take part;
    `quantiles` does not enter the likelihood. Every one of them must be
    fp32, contiguous and on z's device (`check_params`), on the CPU as on
    the card.
    """
    keys = tuple(k for k in params if k != "quantiles")
    z = z.float().contiguous()
    plan = check_params(params, z)
    return _EBLikelihood.apply(z, plan, keys, *(params[k] for k in keys))
