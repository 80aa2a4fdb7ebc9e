"""Conditional distributions for the encoder p(Z|X).

Counterpart of `lossyless_tpu/compressors/distributions.py`: the
`Deterministic` (delta) and `DiagGaussian` families built from the
encoder's sufficient-statistics output, and the KL helpers
`kl_unit_gaussian` / `kl_divergence`. Sampling takes an explicit
`torch.Generator`, or the standard normal draws themselves (`eps`, as the
parity tests pass JAX's); `detach` stops gradients through every
parameter.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core import mesh

MIN_STD = 1e-5


@dataclasses.dataclass(frozen=True)
class Deterministic:
    """Delta distribution (deterministic encoder). Event dim = last axis."""

    loc: torch.Tensor

    n_param = 1

    def rsample(self, generator: torch.Generator | None = None, eps=None):
        return self.loc

    @property
    def mean(self):
        return self.loc

    def log_prob(self, z):
        # 0 at the atom, -inf elsewhere
        hit = torch.all(z == self.loc, dim=-1)
        return torch.where(hit, 0.0, -math.inf)

    def entropy(self):
        return torch.zeros(self.loc.shape[:-1], device=self.loc.device)


@dataclasses.dataclass(frozen=True)
class DiagGaussian:
    """Diagonal Gaussian; scale from softplus(raw) + MIN_STD."""

    loc: torch.Tensor
    scale: torch.Tensor

    n_param = 2

    def rsample(self, generator: torch.Generator | None = None, eps=None):
        if eps is None:   # the global batch's draw in a data-parallel step
            eps = mesh.global_draw(
                lambda s: torch.randn(s, generator=generator,
                                      dtype=self.loc.dtype,
                                      device=self.loc.device),
                tuple(self.loc.shape))
        return self.loc + self.scale * eps

    @property
    def mean(self):
        return self.loc

    def log_prob(self, z):
        var = self.scale ** 2
        lp = -0.5 * ((z - self.loc) ** 2 / var + torch.log(2 * math.pi * var))
        return lp.sum(-1)

    def entropy(self):
        return (0.5 * torch.log(2 * math.pi * math.e * self.scale ** 2)).sum(-1)


def from_suff_param(family: str, suff_param: torch.Tensor):
    """Build the family from concatenated sufficient statistics (B, z*p);
    the parameters of each dim are contiguous (interleaved layout)."""
    if family == "deterministic":
        return Deterministic(suff_param)
    if family == "diaggaussian":
        s = suff_param.reshape(suff_param.shape[0], -1, 2)
        loc, log_var = s[..., 0], s[..., 1]
        return DiagGaussian(loc, F.softplus(log_var) + MIN_STD)
    raise ValueError(f"unknown family={family}")


def n_suff_params(family: str) -> int:
    return {"deterministic": 1, "diaggaussian": 2}[family]


def detach(dist):
    """The same distribution with gradients stopped at every parameter."""
    return dataclasses.replace(dist, **{
        f.name: getattr(dist, f.name).detach()
        for f in dataclasses.fields(dist)})


def kl_unit_gaussian(p: DiagGaussian) -> torch.Tensor:
    """KL[p || N(0, I)] a sample (summed over the event dim)."""
    var = p.scale ** 2
    return (0.5 * (var + p.loc ** 2 - 1.0 - torch.log(var))).sum(-1)


def kl_divergence(p, q_loc, q_scale, z_samples=None):
    """KL[p || N(q_loc, q_scale)] a sample: analytic for a Gaussian p; for
    a deterministic p the single-sample cross-entropy -log q(z) (H[p] = 0)
    at `z_samples`, else at p's atom."""
    if isinstance(p, DiagGaussian):
        var_p, var_q = p.scale ** 2, q_scale ** 2
        kl = 0.5 * (torch.log(var_q / var_p)
                    + (var_p + (p.loc - q_loc) ** 2) / var_q - 1.0)
        return kl.sum(-1)
    z = z_samples if z_samples is not None else p.rsample()
    var_q = torch.as_tensor(q_scale, dtype=z.dtype, device=z.device) ** 2
    lp = -0.5 * ((z - q_loc) ** 2 / var_q + torch.log(2 * math.pi * var_q))
    return -lp.sum(-1)
