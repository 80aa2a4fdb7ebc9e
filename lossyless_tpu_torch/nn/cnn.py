"""Convolutional architectures: the pyramid CNN and BALLE.

Counterpart of `lossyless_tpu/nn/cnn.py`. The CNN is a channel-doubling
pyramid of stride-2 3x3 convs down to side 2 and a `Dense` head; its
decoder mirrors it with a `Dense`, then (norm, activation, stride-2
`ConvTranspose`) per layer. BALLE is a stack of `n_layers` 5x5 stride-2
convs of constant width `hid_dim` whose last one keeps the spatial
structure: `channel_out_dim` channels over a (side / 2^n)^2 grid,
flattened in (H, W, C) order (the layout the spatial hyperprior folds);
its decoder is the same stack of transposed convs, with the inverse
activation (inverse GDN where the activation is GDN). Every conv but the
last is followed by the norm and the activation; a conv has a bias where
no norm follows it, or where it is the last. A side that is not a power
of two is resized to the closest one and back,
with `jax.image.resize(..., "bilinear")`'s arithmetic: half-pixel
centres, antialiased when it shrinks (`F.interpolate(..., antialias=
True)`; without it 128 -> 96 is off by up to ~1.2).

NHWC in and out, as JAX; inside, the NCHW view (`torch.channels_last`).
Parameters keep flax's names (`Conv_i`, `BatchNorm_i`, `ConvTranspose_i`,
`GDN_i`, `Dense_0`). Under `dtype=bfloat16` convs and dense layers run in bf16,
norms in fp32, each activation cast back to bf16; the outputs are fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, ConvTranspose, apply_norm, conv_input,
                     make_activation, make_norm, norm_uses_bias)
from .mlp import Dense, _dtype


def _closest_pow2(n: int) -> int:
    return 2 ** round(math.log2(n))


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` of an NCHW view."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def _add_norm(module: nn.Module, norm_layer, features: int, i: int):
    """A norm registered under flax's name (`BatchNorm_i`, ...); None for
    the identity."""
    norm = make_norm(norm_layer, features)
    if norm is not None:
        module.add_module(f"{type(norm).__name__}_{i}", norm)
    return norm


class CNNEncoder(nn.Module):
    """Image (B, H, W, C) -> vector (B, out_dim)."""

    def __init__(self, out_dim: int, in_shape: Sequence[int],
                 hid_dim: int = 32, norm_layer: str = "batchnorm",
                 activation: str = "relu", n_layers: int | None = None,
                 dtype="float32", generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = in_shape
        self.size = (_closest_pow2(h), _closest_pow2(w))
        self.resize = self.size != (h, w)
        n_layers = n_layers or int(math.log2(min(self.size)) - 1)
        use_bias = norm_uses_bias(norm_layer)
        self.convs, self.norms, self.acts = [], [], []
        cin = c
        for i in range(n_layers):
            cout = hid_dim * 2 ** i
            conv = Conv(cin, cout, 3, 2, 1, use_bias, d, g)
            self.add_module(f"Conv_{i}", conv)
            self.convs.append(conv)
            self.norms.append(_add_norm(self, norm_layer, cout, i))
            self.acts.append(make_activation(self, activation, cout, i))
            cin = cout
        side = [s // 2 ** n_layers for s in self.size]
        self.Dense_0 = Dense(cin * side[0] * side[1], out_dim, dtype=d,
                             generator=g)

    def forward(self, x, *, training: bool = False):
        x = x.permute(0, 3, 1, 2)
        if self.resize:
            x = _resize(x, self.size)
        x = conv_input(x, self.dtype)
        for conv, norm, act in zip(self.convs, self.norms, self.acts):
            x = apply_norm(norm, conv(x), training=training)
            x = act(x).to(self.dtype)
        # flatten in flax's (H, W, C) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_0(x).float()


class CNNDecoder(nn.Module):
    """Vector (B, in_dim) -> image (B, H, W, C) (the transposed CNN)."""

    def __init__(self, in_dim: int, out_shape: Sequence[int],
                 hid_dim: int = 32, norm_layer: str = "batchnorm",
                 activation: str = "relu", n_layers: int | None = None,
                 dtype="float32", generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = out_shape
        self.out_hw = (h, w)
        h2, w2 = _closest_pow2(h), _closest_pow2(w)
        self.resize = (h2, w2) != (h, w)
        n_layers = n_layers or int(math.log2(min(h2, w2)) - 1)
        use_bias = norm_uses_bias(norm_layer)
        channels = [hid_dim * 2 ** i for i in range(n_layers)][::-1]
        self.start = (h2 // 2 ** n_layers, w2 // 2 ** n_layers, channels[0])
        self.Dense_0 = Dense(in_dim, math.prod(self.start), use_bias, d, g)
        outs = channels[1:] + [c]
        self.norms, self.acts, self.convs = [], [], []
        cin = channels[0]
        for i, cout in enumerate(outs):
            self.norms.append(_add_norm(self, norm_layer, cin, i))
            self.acts.append(make_activation(self, activation, cin, i))
            conv = ConvTranspose(cin, cout, 3, 2,
                                 use_bias or i == len(outs) - 1, d, g)
            self.add_module(f"ConvTranspose_{i}", conv)
            self.convs.append(conv)
            cin = cout

    def forward(self, z, *, training: bool = False):
        x = self.Dense_0(z.to(self.dtype))
        x = x.reshape(z.shape[0], *self.start).permute(0, 3, 1, 2)
        for norm, act, conv in zip(self.norms, self.acts, self.convs):
            x = act(apply_norm(norm, x, training=training)).to(self.dtype)
            x = conv(x)
        if self.resize:
            x = _resize(x.float(), self.out_hw)
        return x.float().permute(0, 2, 3, 1)


def balle_channel_out_dim(out_dim: int, in_shape, n_layers: int) -> int:
    """The channels of BALLE's last feature map: `out_dim` over its
    positions, which must divide it."""
    h, w, _ = in_shape
    h2, w2 = _closest_pow2(h), _closest_pow2(w)
    eh, ew = h2 // 2 ** n_layers, w2 // 2 ** n_layers
    if out_dim % (eh * ew) != 0:
        raise ValueError(
            f"BALLE out_dim={out_dim} must be divisible by the {eh * ew} "
            f"spatial positions of the final feature map ({eh}x{ew} for "
            f"input {h}x{w} with n_layers={n_layers}); a floor-divided "
            f"latent would silently be "
            f"{(out_dim // (eh * ew)) * eh * ew}-dimensional")
    return out_dim // (eh * ew)


class BalleEncoder(nn.Module):
    """Image (B, H, W, C) -> the flattened spatial latent (B, out_dim)."""

    def __init__(self, out_dim: int, in_shape: Sequence[int],
                 hid_dim: int = 256, n_layers: int = 4,
                 norm_layer: str = "batchnorm", activation: str = "relu",
                 dtype="float32", generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = in_shape
        self.size = (_closest_pow2(h), _closest_pow2(w))
        self.resize = self.size != (h, w)
        self.channel_out_dim = balle_channel_out_dim(out_dim, in_shape,
                                                     n_layers)
        use_bias = norm_uses_bias(norm_layer)
        self.convs, self.norms, self.acts = [], [], []
        cin = c
        for i in range(n_layers):
            is_last = i == n_layers - 1
            cout = self.channel_out_dim if is_last else hid_dim
            conv = Conv(cin, cout, 5, 2, 2, use_bias or is_last, d, g)
            self.add_module(f"Conv_{i}", conv)
            self.convs.append(conv)
            if not is_last:
                self.norms.append(_add_norm(self, norm_layer, cout, i))
                self.acts.append(make_activation(self, activation, cout, i))
            cin = cout

    def forward(self, x, *, training: bool = False):
        x = x.permute(0, 3, 1, 2)
        if self.resize:
            x = _resize(x, self.size)
        x = conv_input(x, self.dtype)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.norms):
                x = apply_norm(self.norms[i], x, training=training)
                x = self.acts[i](x).to(self.dtype)
        # flatten in flax's (H, W, C) order
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()


class BalleDecoder(nn.Module):
    """The flattened spatial latent (B, in_dim) -> image (B, H, W, C)."""

    def __init__(self, in_dim: int, out_shape: Sequence[int],
                 hid_dim: int = 256, n_layers: int = 4,
                 norm_layer: str = "batchnorm", activation: str = "relu",
                 dtype="float32", generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = out_shape
        self.out_hw = (h, w)
        h2, w2 = _closest_pow2(h), _closest_pow2(w)
        self.resize = (h2, w2) != (h, w)
        eh, ew = h2 // 2 ** n_layers, w2 // 2 ** n_layers
        self.start = (eh, ew, in_dim // (eh * ew))
        use_bias = norm_uses_bias(norm_layer)
        self.convs, self.norms, self.acts = [], [], []
        cin = self.start[2]
        for i in range(n_layers):
            is_last = i == n_layers - 1
            cout = c if is_last else hid_dim
            conv = ConvTranspose(cin, cout, 5, 2, use_bias or is_last, d, g)
            self.add_module(f"ConvTranspose_{i}", conv)
            self.convs.append(conv)
            if not is_last:
                self.norms.append(_add_norm(self, norm_layer, cout, i))
                self.acts.append(make_activation(self, activation, cout, i,
                                                 inverse=True))
            cin = cout

    def forward(self, z, *, training: bool = False):
        x = z.reshape(z.shape[0], *self.start).to(self.dtype)
        x = x.permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.norms):
                x = apply_norm(self.norms[i], x, training=training)
                x = self.acts[i](x).to(self.dtype)
        if self.resize:
            x = _resize(x.float(), self.out_hw)
        return x.float().permute(0, 2, 3, 1)
