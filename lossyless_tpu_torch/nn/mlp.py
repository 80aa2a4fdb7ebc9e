"""MLP family: MLP / FlattenMLP / FlattenLinear / Identity.

Counterpart of `lossyless_tpu/nn/mlp.py`. Parameters keep flax's names and
layouts (`Dense_i.kernel` of shape (in, out), `Dense_i.bias`, norms
`BatchNorm_i` / `LayerNorm_i`), so `params_from_flax` (from `nn/layers.py`)
carries a JAX tree over by joining its path with dots. torch needs the
input width at construction (flax infers it at init): each module takes
`in_dim` or `in_shape`. No bias under a norm, the last layer always biased, hidden
activations cast to the compute dtype, the output fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .layers import (KAIMING_UNIFORM, apply_norm, make_activation, make_norm,
                     norm_uses_bias)
from .layers import params_from_flax  # noqa: F401 (re-export)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _prod(shape) -> int:
    return shape if isinstance(shape, int) else math.prod(shape)


def _as_tuple(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


class Dense(nn.Module):
    """flax `nn.Dense`: `x @ kernel + bias` in the compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 kernel_init=KAIMING_UNIFORM):
        super().__init__()
        self.dtype = _dtype(dtype)
        g = generator or torch.Generator().manual_seed(0)
        self.kernel = nn.Parameter(kernel_init((in_dim, out_dim), g))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hid_dim: int = 128,
                 n_hid_layers: int = 1, norm_layer: str = "identity",
                 activation: str = "relu", dropout_p: float = 0.0,
                 dtype="float32", generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = _dtype(dtype)
        self.n_hid_layers = n_hid_layers
        self.dropout = nn.Dropout(dropout_p) if dropout_p > 0 else None
        use_bias = norm_uses_bias(norm_layer)
        dims = [in_dim] + [hid_dim] * n_hid_layers
        # registered below under flax's names
        self._norms, self._acts = [], []
        for i in range(n_hid_layers):
            self.add_module(f"Dense_{i}", Dense(dims[i], hid_dim, use_bias,
                                                self.dtype, generator))
            norm = make_norm(norm_layer, hid_dim)
            if norm is not None:
                self.add_module(f"{type(norm).__name__}_{i}", norm)
            self._norms.append(norm)
            self._acts.append(make_activation(self, activation, hid_dim, i))
        self.add_module(f"Dense_{n_hid_layers}", Dense(
            dims[-1], out_dim, True, self.dtype, generator))

    def forward(self, x, *, training: bool = False):
        # flatten everything but batch into features
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.n_hid_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = apply_norm(self._norms[i], x, training=training)
            x = self._acts[i](x).to(self.dtype)
            if self.dropout is not None and training:
                x = self.dropout(x)
        return getattr(self, f"Dense_{self.n_hid_layers}")(x).float()


class FlattenMLP(nn.Module):
    """MLP over the flattened input, reshaped to `out_shape`."""

    def __init__(self, in_shape, out_shape: int | Sequence[int],
                 hid_dim: int = 128, n_hid_layers: int = 1,
                 norm_layer: str = "identity", activation: str = "relu",
                 dropout_p: float = 0.0, dtype="float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = _as_tuple(out_shape)
        self.MLP_0 = MLP(_prod(in_shape), _prod(self.out_shape), hid_dim,
                         n_hid_layers, norm_layer, activation, dropout_p,
                         dtype, generator)

    def forward(self, x, *, training: bool = False):
        y = self.MLP_0(x, training=training)
        return y.reshape((x.shape[0],) + self.out_shape)


class FlattenLinear(nn.Module):
    """One linear layer over the flattened input."""

    def __init__(self, in_shape, out_shape: int | Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = _as_tuple(out_shape)
        self.Dense_0 = Dense(_prod(in_shape), _prod(self.out_shape),
                             generator=generator)

    def forward(self, x, *, training: bool = False):
        y = self.Dense_0(x.reshape(x.shape[0], -1))
        return y.reshape((x.shape[0],) + self.out_shape)


class Identity(nn.Module):
    def forward(self, x, *, training: bool = False):
        return x
