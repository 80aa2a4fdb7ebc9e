"""The pyramid CNN: an encoder and its transposed decoder.

Counterpart of the CNN half of `lossyless_tpu/nn/cnn.py` (BALLE waits for
ROADMAP queue 1 order 5): a channel-doubling pyramid of stride-2 3x3
convs down to side 2 and a `Dense` head; the decoder mirrors it with a
`Dense`, then (norm, activation, stride-2 `ConvTranspose`) per layer. A
side that is not a power of two is resized to the closest one and back,
with `jax.image.resize(..., "bilinear")`'s arithmetic: half-pixel
centres, antialiased when it shrinks (`F.interpolate(..., antialias=
True)`; without it 128 -> 96 is off by up to ~1.2).

NHWC in and out, as JAX; inside, the NCHW view (`torch.channels_last`).
Parameters keep flax's names (`Conv_i`, `BatchNorm_i`, `ConvTranspose_i`,
`Dense_0`). Under `dtype=bfloat16` convs and dense layers run in bf16,
norms in fp32, each activation cast back to bf16; the outputs are fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, ConvTranspose, apply_norm, get_activation,
                     make_norm, norm_uses_bias)
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
        self.act = get_activation(activation)
        self.convs, self.norms = [], []
        cin = c
        for i in range(n_layers):
            cout = hid_dim * 2 ** i
            conv = Conv(cin, cout, 3, 2, 1, use_bias, d, g)
            self.add_module(f"Conv_{i}", conv)
            self.convs.append(conv)
            self.norms.append(_add_norm(self, norm_layer, cout, i))
            cin = cout
        side = [s // 2 ** n_layers for s in self.size]
        self.Dense_0 = Dense(cin * side[0] * side[1], out_dim, dtype=d,
                             generator=g)

    def forward(self, x, *, training: bool = False):
        x = x.permute(0, 3, 1, 2)
        if self.resize:
            x = _resize(x, self.size)
        x = x.to(self.dtype)
        for conv, norm in zip(self.convs, self.norms):
            x = apply_norm(norm, conv(x), training=training)
            x = self.act(x).to(self.dtype)
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
        self.act = get_activation(activation)
        channels = [hid_dim * 2 ** i for i in range(n_layers)][::-1]
        self.start = (h2 // 2 ** n_layers, w2 // 2 ** n_layers, channels[0])
        self.Dense_0 = Dense(in_dim, math.prod(self.start), use_bias, d, g)
        outs = channels[1:] + [c]
        self.norms, self.convs = [], []
        cin = channels[0]
        for i, cout in enumerate(outs):
            self.norms.append(_add_norm(self, norm_layer, cin, i))
            conv = ConvTranspose(cin, cout, 3, 2,
                                 use_bias or i == len(outs) - 1, d, g)
            self.add_module(f"ConvTranspose_{i}", conv)
            self.convs.append(conv)
            cin = cout

    def forward(self, z, *, training: bool = False):
        x = self.Dense_0(z.to(self.dtype))
        x = x.reshape(z.shape[0], *self.start).permute(0, 3, 1, 2)
        for norm, conv in zip(self.norms, self.convs):
            x = self.act(apply_norm(norm, x, training=training)).to(
                self.dtype)
            x = conv(x)
        if self.resize:
            x = _resize(x.float(), self.out_hw)
        return x.float().permute(0, 2, 3, 1)
