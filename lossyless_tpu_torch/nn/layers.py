"""Shared layers: the initializer, activations and norms the MLPs use.

Counterpart of the part of `lossyless_tpu/nn/layers.py` that `nn/mlp.py`
needs: `KAIMING_UNIFORM`, `get_activation`, `norm_uses_bias` and the
identity, batch and layer norms, computed with flax's formulas (the fast
variance E[x^2] - E[x]^2, batch norm eps 1e-5 and running averages with
momentum 0.9, layer norm eps 1e-6) so that JAX params and statistics carry
over. GDN and the group norm wait for the BALLE slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9


def KAIMING_UNIFORM(shape, generator: torch.Generator) -> torch.Tensor:
    """flax `variance_scaling(2.0, "fan_in", "uniform")` for a dense
    kernel of shape (fan_in, fan_out): U(-sqrt(6 / fan_in), +...)."""
    limit = math.sqrt(6.0 / shape[0])
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


def norm_uses_bias(norm_layer: str | None) -> bool:
    """Dense bias is dropped under any norm."""
    return norm_layer in (None, "identity")


def get_activation(activation: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation function of the JAX package's name (gelu is the tanh
    approximation, jax.nn.gelu's default)."""
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
        raise NotImplementedError(
            "GDN is not ported yet (the BALLE slice, ROADMAP queue 1 item 7)")
    if key in acts:
        return acts[key]
    raise ValueError(f"unknown activation={activation}")


def _fast_stats(x: torch.Tensor, dims):
    mean = x.mean(dims, keepdim=True)
    var = torch.clamp((x * x).mean(dims, keepdim=True) - mean * mean, min=0)
    return mean, var


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9)` over the leading axis: params
    `scale`, `bias`; running `mean`, `var` (biased) as buffers."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, *, training: bool):
        xf = x.float()
        if training:
            mean, var = _fast_stats(xf, 0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM)
                                                 * mean[0])
                self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var[0])
        else:
            mean, var = self.mean, self.var
        return (xf - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the last axis (eps 1e-6)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, *, training: bool):
        xf = x.float()
        mean, var = _fast_stats(xf, -1)
        return (xf - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


def make_norm(norm_layer: str | None, features: int) -> nn.Module | None:
    """The norm module of the name, or None for identity; flax's module
    name prefix is its class name (`BatchNorm_0`, `LayerNorm_0`)."""
    if norm_layer in (None, "identity"):
        return None
    if "batch" in norm_layer:
        return BatchNorm(features)
    if "layer" in norm_layer:
        return LayerNorm(features)
    if "group" in norm_layer:
        raise NotImplementedError(
            "the group norm is not ported yet (ROADMAP queue 1 item 7)")
    raise ValueError(f"unknown norm_layer={norm_layer}")


def apply_norm(norm: nn.Module | None, x, *, training: bool):
    """Apply a norm from `make_norm` (None is the identity)."""
    return x if norm is None else norm(x, training=training)
