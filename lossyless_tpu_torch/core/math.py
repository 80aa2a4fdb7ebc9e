"""Numerical primitives shared across the port.

Counterpart of `lossyless_tpu/core/math.py`: CompressAI's `LowerBound`
straight-through op used by the entropy models, and a straight-through
round. Both are `torch.autograd.Function`s where the JAX code has a
`custom_vjp`.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """`max(x, bound)` with a straight-through-ish gradient.

    The gradient passes when the input is above the bound, or when it is
    below but the gradient pushes it up (CompressAI's LowerBound
    convention), so likelihoods cannot collapse to 0 yet can recover.
    """
    return _LowerBound.apply(x, float(bound))


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)  # half to even, like jnp.round

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through (identity) gradient."""
    return _SteRound.apply(x)
