"""Shared layers: initializers, activations, norms and convolutions.

Counterpart of `lossyless_tpu/nn/layers.py`: the initializers
(`KAIMING_UNIFORM`, `KAIMING_NORMAL_OUT`, flax's `LECUN_NORMAL`),
`get_activation` (GDN as a factory, `GDN(features)`, which
`make_activation` registers under flax's name `GDN_i`),
`norm_uses_bias` and the identity, batch, group and layer norms of
`apply_norm`, computed with flax's formulas (the fast variance E[x^2] -
E[x]^2; batch norm eps 1e-5 with running averages at momentum 0.9; group
norm 8 groups where the channels divide by 8, else 1, and layer norm, both
eps 1e-6) so that JAX params and statistics carry over. Every norm takes
the channels on dim 1: (batch, features) or an NCHW view.

`Conv` and `ConvTranspose` are flax's `nn.Conv` / `nn.ConvTranspose` on
that NCHW view (the NHWC tensors of the JAX layout, permuted: a
`torch.channels_last` view, which cuDNN's tensor-core convolutions take
as it is), in the compute dtype, out and in. `params_from_flax` maps a
flax tree onto these modules' state dicts.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import mesh
from ..core.math import lower_bound
from ..core.profiling import span

BN_MOMENTUM = 0.9


def KAIMING_UNIFORM(shape, generator: torch.Generator) -> torch.Tensor:
    """flax `variance_scaling(2.0, "fan_in", "uniform")` for a dense
    kernel of shape (fan_in, fan_out): U(-sqrt(6 / fan_in), +...)."""
    limit = math.sqrt(6.0 / shape[0])
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


def KAIMING_NORMAL_OUT(shape, generator: torch.Generator) -> torch.Tensor:
    """flax `variance_scaling(2.0, "fan_out", "normal")` for a conv kernel
    of flax's shape (kh, kw, in, out): N(0, 2 / (out * kh * kw))."""
    kh, kw, _, cout = shape
    return torch.randn(shape, generator=generator) * math.sqrt(
        2.0 / (cout * kh * kw))


def LECUN_NORMAL(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's default dense init for a kernel (fan_in, fan_out): a normal
    truncated at 2 standard deviations, of variance 1 / fan_in."""
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def norm_uses_bias(norm_layer: str | None) -> bool:
    """Dense bias is dropped under any norm."""
    return norm_layer in (None, "identity")


class GDN(nn.Module):
    """Generalized divisive normalization (Balle et al. 2016), JAX's
    `nn.layers.GDN` on the channels (dim 1: (batch, features) or an NCHW
    view):

        y_i = x_i / sqrt(beta_i + sum_j gamma_ji x_j^2)   (inverse=False)
        y_i = x_i * sqrt(...)                             (inverse=True)

    The parameters are stored as square roots (`beta_sqrt`, `gamma_sqrt`,
    flax's names), `beta_sqrt` lower-bounded at `beta_min ** 0.5`. The
    normalizer is computed in fp32 and the output cast back to the
    input's dtype."""

    def __init__(self, features: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse, self.beta_min = inverse, beta_min
        self.beta_sqrt = nn.Parameter(torch.ones(features))
        self.gamma_sqrt = nn.Parameter(
            torch.sqrt(gamma_init * torch.eye(features)))

    def forward(self, x):
        beta = lower_bound(self.beta_sqrt, self.beta_min ** 0.5) ** 2
        gamma = self.gamma_sqrt ** 2
        x32 = x.float()
        norm = (x32 * x32).movedim(1, -1) @ gamma + beta
        norm = norm.movedim(-1, 1)
        out = x32 * (torch.sqrt(norm) if self.inverse
                     else torch.rsqrt(norm))
        return out.to(x.dtype)


def get_activation(activation: str, inverse: bool = False) -> Callable:
    """The activation function of the JAX package's name (gelu is the tanh
    approximation, jax.nn.gelu's default); for "gdn" the factory
    `GDN(features)` (inverted with `inverse`), as JAX's factory builds a
    GDN module."""
    acts = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "swish": F.silu,
        "tanh": torch.tanh,
        "elu": F.elu,
        "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
        "quickgelu": lambda x: x * torch.sigmoid(1.702 * x),
    }
    key = activation.lower()
    if key == "gdn":
        return functools.partial(GDN, inverse=inverse)
    if key in acts:
        return acts[key]
    raise ValueError(f"unknown activation={activation}")


def make_activation(module: nn.Module, activation: str, features: int,
                    i: int, inverse: bool = False) -> Callable:
    """The activation of a stack's i-th layer: the function, or for GDN a
    `GDN(features)` registered on `module` under flax's name `GDN_i`."""
    act = get_activation(activation, inverse)
    if activation.lower() != "gdn":
        return act
    gdn = act(features)
    module.add_module(f"GDN_{i}", gdn)
    return gdn


def _fast_stats(x: torch.Tensor, dims):
    mean = x.mean(dims, keepdim=True)
    var = torch.clamp((x * x).mean(dims, keepdim=True) - mean * mean, min=0)
    return mean, var


def _batch_stats(x: torch.Tensor, dims):
    """`_fast_stats` over the batch; in a data-parallel step over the
    global batch (JAX's BatchNorm under pjit, SyncBatchNorm's semantics):
    the rank's per-channel E[x] and E[x^2] summed over the ranks in one
    differentiable all-reduce and divided by the world size (the ranks
    hold equal shards, so the mean of their means is the global batch's),
    then flax's E[x^2] - E[x]^2. In a world of one that is `_fast_stats`
    bit for bit."""
    dp = mesh.active()
    if dp is None:
        return _fast_stats(x, dims)
    mean, sq = (mesh.all_reduce_sum(torch.stack(
        [x.mean(dims, keepdim=True), (x * x).mean(dims, keepdim=True)]))
        / dp[1]).unbind()
    return mean, torch.clamp(sq - mean * mean, min=0)


def _stat_dims(x: torch.Tensor) -> tuple:
    """Every dim but the channels' (dim 1)."""
    return (0,) + tuple(range(2, x.dim()))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over x's channel dim 1."""
    return v.reshape((-1,) + (1,) * (x.dim() - 2))


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9)` over every dim but the channels'
    (1): params `scale`, `bias`; running `mean`, `var` (biased) as
    buffers. fp32 out, whatever the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, *, training: bool):
        with span("nn.batchnorm"):
            xf = x.float()
            if training:
                mean, var = _batch_stats(xf, _stat_dims(xf))
                with torch.no_grad():
                    self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM)
                                                     * mean.reshape(-1))
                    self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM)
                                                    * var.reshape(-1))
            else:
                mean, var = (_per_channel(v, xf)
                             for v in (self.mean, self.var))
            out = (xf - mean) * torch.rsqrt(var + self.eps) \
                * _per_channel(self.scale, xf) + _per_channel(self.bias, xf)
        if xf.requires_grad and torch.autograd._profiler_enabled():
            _backward_span("nn.batchnorm.backward", xf, out)
        return out


def _backward_span(name: str, inp: torch.Tensor, out: torch.Tensor):
    """Span `name` on autograd's thread from the gradient reaching `out` to
    the gradient of `inp` (tensor hooks, which only a profiled forward
    registers)."""
    opened = []

    def begin(grad):
        cm = span(name)
        cm.__enter__()
        opened.append(cm)

    def end(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.register_hook(begin)
    inp.register_hook(end)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the channels (dim 1; eps 1e-6)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, *, training: bool):
        xf = x.float()
        mean, var = _fast_stats(xf, 1)
        return (xf - mean) * torch.rsqrt(var + self.eps) \
            * _per_channel(self.scale, xf) + _per_channel(self.bias, xf)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups)` (eps 1e-6): the channels (dim 1) in
    8 groups where they divide by 8, else 1 (`apply_norm`'s rule), each
    normalized over itself and every dim past the channels'."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.groups = 8 if features % 8 == 0 else 1
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, *, training: bool):
        xf = x.float()
        g = xf.reshape(xf.shape[0], self.groups, -1)
        mean, var = _fast_stats(g, -1)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(xf.shape)
        return y * _per_channel(self.scale, xf) + _per_channel(self.bias, xf)


def make_norm(norm_layer: str | None, features: int) -> nn.Module | None:
    """The norm module of the name, or None for identity; flax's module
    name prefix is its class name (`BatchNorm_0`, `GroupNorm_0`,
    `LayerNorm_0`)."""
    if norm_layer in (None, "identity"):
        return None
    if "batch" in norm_layer:
        return BatchNorm(features)
    if "layer" in norm_layer:
        return LayerNorm(features)
    if "group" in norm_layer:
        return GroupNorm(features)
    raise ValueError(f"unknown norm_layer={norm_layer}")


def apply_norm(norm: nn.Module | None, x, *, training: bool):
    """Apply a norm from `make_norm` (None is the identity)."""
    return x if norm is None else norm(x, training=training)


def _as_pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """flax `nn.Conv(features, kernel_size, strides, padding)` on an NCHW
    view, in the compute dtype. `kernel` is flax's (kh, kw, in, out)
    permuted to torch's (out, in, kh, kw). `padding` is symmetric, in
    pixels (flax's `SAME` at kernel 1 is 0)."""

    def __init__(self, cin: int, cout: int, kernel_size, strides=1,
                 padding=0, use_bias: bool = True, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.strides, self.padding = _as_pair(strides), _as_pair(padding)
        self.dtype = dtype
        g = generator or torch.Generator().manual_seed(0)
        self.kernel = nn.Parameter(KAIMING_NORMAL_OUT(
            (kh, kw, cin, cout), g).permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype), b,
                        self.strides, self.padding)


def _same_transpose_pads(k: int, s: int) -> tuple[int, int]:
    """The (before, after) padding of the dilated input that flax's
    `ConvTranspose(padding="SAME")` takes (`lax.conv_transpose`)."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return before, pad_len - before


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose(features, kernel_size, strides,
    padding="SAME")` on an NCHW view, in the compute dtype.

    flax runs `lax.conv_transpose` without `transpose_kernel`: a
    correlation of the unflipped kernel over the zero-dilated input padded
    (k + s - 2) split as `_same_transpose_pads` says ((2, 1) at k = 3,
    s = 2). `F.conv_transpose2d` is that correlation of the FLIPPED kernel
    over the input padded (k - 1, k - 1); so `kernel` holds flax's
    (kh, kw, in, out) flipped in both spatial dims as torch's (in, out,
    kh, kw), and the output is cropped to flax's padding."""

    def __init__(self, cin: int, cout: int, kernel_size, strides=2,
                 use_bias: bool = True, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = _as_pair(kernel_size)
        self.strides = _as_pair(strides)
        # conv_transpose2d pads k - 1 on both sides: crop down to flax's
        self.crops = [tuple(k - 1 - p for p in _same_transpose_pads(k, s))
                      for k, s in zip((kh, kw), self.strides)]
        self.dtype = dtype
        g = generator or torch.Generator().manual_seed(0)
        self.kernel = nn.Parameter(flip_transpose_kernel(
            KAIMING_NORMAL_OUT((kh, kw, cin, cout), g)))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv_transpose2d(x.to(self.dtype), self.kernel.to(self.dtype),
                               b, self.strides)
        (t, bo), (le, ri) = self.crops
        return y[:, :, t:y.shape[2] - bo, le:y.shape[3] - ri]


def flip_transpose_kernel(k: torch.Tensor) -> torch.Tensor:
    """flax's ConvTranspose kernel (kh, kw, in, out) -> `ConvTranspose`'s
    (in, out, kh, kw), flipped in both spatial dims."""
    return k.flip(0, 1).permute(2, 3, 0, 1).contiguous()


def numpy_state_dict(torch_state_dict) -> dict:
    """A public checkpoint's tensors as fp32 numpy arrays, cast with
    `.float()` first (CLIP ships fp16), for the converters' layout
    work."""
    return {k: np.asarray(v.float().cpu().numpy() if hasattr(v, "cpu")
                          else v, dtype=np.float32)
            for k, v in torch_state_dict.items()}


def merge_stats(params: dict, stats: dict) -> dict:
    """flax params with the batch_stats collection merged in, path by
    path (running `mean` / `var` beside `scale` / `bias`): the tree
    `params_from_flax` takes."""
    out = dict(params)
    for k, v in stats.items():
        out[k] = merge_stats(out.get(k, {}), v) if isinstance(v, dict) \
            else v
    return out


def params_from_flax(tree, prefix: str = "") -> dict:
    """A flax tree (nested dicts of arrays; `params` and `batch_stats`
    merged) -> a state dict: the path joined with dots, fp32 tensors. A
    conv kernel goes to its module's layout: `Conv_i` (out, in, kh, kw),
    `ConvTranspose_i` flipped (`flip_transpose_kernel`)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(params_from_flax(v, name + "."))
            continue
        t = torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        parent = prefix.rstrip(".").rsplit(".", 1)[-1]
        if k == "kernel" and t.dim() == 4:
            t = flip_transpose_kernel(t) if parent.startswith(
                "ConvTranspose_") else t.permute(3, 2, 0, 1).contiguous()
        out[name] = t
    return out
