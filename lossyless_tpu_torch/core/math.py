"""Numerical primitives shared across the port.

Counterpart of `lossyless_tpu/core/math.py`: CompressAI's `LowerBound`
straight-through op used by the entropy models, a straight-through
round (both `torch.autograd.Function`s where the JAX code has a
`custom_vjp`), `abs_jax`, |x| with `jnp.abs`'s derivative at 0, and the
nats-to-bits conversion of every reported entropy.
"""

from __future__ import annotations

import torch

BASE_LOG = 2  # every reported entropy is in bits
LOG2 = 0.6931471805599453


def nats_to_bits(x):
    return x / LOG2


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


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative: +1 at 0, where torch's `abs` gives 0.

    `jax.grad(jnp.abs)(0.) == 1.0`; every loss and likelihood the JAX
    package writes with `jnp.abs` keeps that gradient at an exact tie.
    """
    return torch.where(x >= 0, x, -x)
