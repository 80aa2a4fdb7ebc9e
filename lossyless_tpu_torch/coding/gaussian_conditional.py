"""Conditional Gaussian entropy model (scale hyperprior, Balle et al. 2018).

Counterpart of `lossyless_tpu/coding/gaussian_conditional.py`: per-element
Gaussians whose scales (and optionally means) a side network predicts,
coded against a shared 64-level log-spaced scale table. Plain functions;
everything is a float32 island. Training noise is passed in (the caller
draws it), so the same U(-0.5, 0.5) draws give the same result on both
sides of a parity test.

`build_cdf_tables` has the JAX package's two arithmetics: ``"float64"``
(numpy/scipy, the default, what the package's own coders use) and
``"compressai"`` (torch fp32 on the host, op for op CompressAI's
`GaussianConditional.update()`, for stream interop).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erfc as np_erfc
from scipy.special import erfcinv as np_erfcinv

from ..core.math import lower_bound
from .entropy_bottleneck import CdfTables

LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
SCALE_BOUND = 0.11


def default_scale_table(min_scale=0.11, max_scale=256.0,
                        levels=64) -> np.ndarray:
    """64 log-spaced scales, float64."""
    return np.exp(np.linspace(math.log(min_scale), math.log(max_scale),
                              levels))


def compressai_scale_table(min_scale=0.11, max_scale=256.0,
                           levels=64) -> np.ndarray:
    """The scale table as CompressAI's get_scale_table computes it (torch
    fp32 linspace/exp); pair it with `build_cdf_tables(...,
    arithmetic="compressai")` for stream interop."""
    return torch.exp(torch.linspace(math.log(min_scale), math.log(max_scale),
                                    levels)).numpy()


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erfc (stable in the upper tail)."""
    return 0.5 * torch.special.erfc(-x * (2 ** -0.5))


def likelihood(z: torch.Tensor, scales: torch.Tensor,
               means: torch.Tensor | None = None,
               scale_bound: float = SCALE_BOUND) -> torch.Tensor:
    """P(round(Z) = z | scale, mean) for a Gaussian; shapes broadcast."""
    z = z.float()
    scales = lower_bound(scales.float(), scale_bound)
    values = z - means.float() if means is not None else z
    values = torch.abs(values)
    upper = standardized_cumulative((0.5 - values) / scales)
    lower = standardized_cumulative((-0.5 - values) / scales)
    return upper - lower


def quantize(z: torch.Tensor, mode: str, means: torch.Tensor | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """'noise' (z + noise), 'dequantize' (round(z - m) + m) or 'symbols'."""
    z = z.float()
    if mode == "noise":
        if noise is None:
            raise ValueError("mode='noise' needs the noise tensor")
        return z + noise
    m = means.float() if means is not None else 0.0
    if mode == "dequantize":
        return torch.round(z - m) + m
    if mode == "symbols":
        return torch.round(z - m).to(torch.int32)
    raise ValueError(f"unknown quantize mode {mode}")


def forward(z: torch.Tensor, scales: torch.Tensor,
            means: torch.Tensor | None = None, *, training: bool,
            noise: torch.Tensor | None = None,
            scale_bound: float = SCALE_BOUND):
    """(z_hat, floored likelihoods), as `GaussianConditional.forward`."""
    z_hat = quantize(z, "noise" if training else "dequantize", means, noise)
    lik = likelihood(z_hat, scales, means, scale_bound)
    return z_hat, lower_bound(lik, LIKELIHOOD_BOUND)


def build_indexes(scales: torch.Tensor,
                  scale_table: np.ndarray) -> torch.Tensor:
    """Index of the smallest table scale >= each element's scale (the
    count of table entries strictly below it, the last entry saturating)."""
    st = torch.as_tensor(np.asarray(scale_table[:-1]), dtype=torch.float32,
                         device=scales.device)
    scales = torch.clamp(scales.float(), min=float(scale_table[0]))
    return (scales[..., None] > st).sum(-1).to(torch.int32)


def build_cdf_tables(scale_table: np.ndarray, tail_mass: float = TAIL_MASS,
                     arithmetic: str = "float64") -> CdfTables:
    """Quantized CDFs per table scale (the reference's scale-table path)."""
    if arithmetic == "compressai":
        return _compressai_fp32_tables(scale_table, tail_mass)
    if arithmetic != "float64":
        raise ValueError(f"unknown arithmetic={arithmetic!r}")
    from .rans import pmf_to_quantized_cdf

    st = np.asarray(scale_table, dtype=np.float64)
    multiplier = -_np_standardized_quantile(tail_mass / 2)
    pmf_center = np.ceil(st * multiplier).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(np.arange(max_length, dtype=np.float64)[None, :]
                     - pmf_center[:, None])
    upper = _np_standardized_cumulative((0.5 - samples) / st[:, None])
    lower = _np_standardized_cumulative((-0.5 - samples) / st[:, None])
    pmf = upper - lower
    tail = 2.0 * lower[:, :1]

    cdf = np.zeros((len(st), max_length + 2), dtype=np.int32)
    for i in range(len(st)):
        prob = np.concatenate([pmf[i, : pmf_length[i]], tail[i]])
        row = pmf_to_quantized_cdf(prob)
        cdf[i, : len(row)] = row
    return CdfTables(quantized_cdf=cdf,
                     cdf_length=(pmf_length + 2).astype(np.int32),
                     offset=(-pmf_center).astype(np.int32))


def _compressai_fp32_tables(scale_table, tail_mass: float) -> CdfTables:
    """Torch-fp32 table build, op for op CompressAI's
    GaussianConditional.update(): fp32 scale table, scipy-ppf multiplier
    (a float64 scalar, fp32 product), torch erfc cumulative, int32
    centers. Any change in how this computes breaks cross-decoding."""
    from scipy.stats import norm as _norm

    from .rans import pmf_to_quantized_cdf

    st = torch.as_tensor(np.asarray(scale_table), dtype=torch.float32)
    multiplier = -float(_norm.ppf(tail_mass / 2))
    pmf_center = torch.ceil(st * multiplier).int()
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = torch.abs(
        torch.arange(max_length).int() - pmf_center[:, None]).float()
    sscale = st.unsqueeze(1)

    def cum(x):
        return 0.5 * torch.erfc(float(-(2 ** -0.5)) * x)

    upper = cum((0.5 - samples) / sscale)
    lower = cum((-0.5 - samples) / sscale)
    pmf = upper - lower
    tail = 2.0 * lower[:, :1]

    cdf = np.zeros((len(st), max_length + 2), dtype=np.int32)
    for i in range(len(st)):
        prob = pmf[i, : int(pmf_length[i])].tolist() + [float(tail[i, 0])]
        row = pmf_to_quantized_cdf(np.asarray(prob, np.float64))
        cdf[i, : len(row)] = row
    return CdfTables(quantized_cdf=cdf,
                     cdf_length=(pmf_length + 2).numpy().astype(np.int32),
                     offset=(-pmf_center).numpy().astype(np.int32))


def _np_standardized_cumulative(x):
    return 0.5 * np_erfc(-x * (2 ** -0.5))


def _np_standardized_quantile(q):
    # inverse of _np_standardized_cumulative
    return -math.sqrt(2.0) * np_erfcinv(2.0 * q)
