"""Fully-factorized learned entropy model ("entropy bottleneck"), in torch.

Counterpart of `lossyless_tpu/coding/entropy_bottleneck.py`: the univariate
non-parametric density of Ballé et al. 2018 (appendix 6.1) behind the hub
compressor. Plain functions over a parameter dict of tensors in the
CompressAI checkpoint layout (`matrix{i} (C, out, in)`, `bias{i}`,
`factor{i}`, `quantiles (C, 1, 3)`), so the JAX package's numpy params and
the published checkpoints pass through unchanged.

Everything here is a float32 island: bf16 inputs are cast up explicitly.
The batch axis is the trailing axis of a `(channels, 1, batch)` layout, so
the per-channel (<=3x3) chain is one batched matmul per layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import mesh
from ..core.math import abs_jax, lower_bound

LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9


@dataclasses.dataclass(frozen=True)
class EBConfig:
    channels: int
    filters: Sequence[int] = (3, 3, 3)
    init_scale: float = 10.0


def init_params(cfg: EBConfig, generator: torch.Generator) -> dict:
    """Initialize parameters; layout mirrors the reference checkpoint format.

    The random biases come from `generator`, so a seed fixes them (they are
    not the JAX package's numbers for the same seed).
    """
    filters = (1,) + tuple(cfg.filters) + (1,)
    n_layers = len(cfg.filters) + 1
    scale = cfg.init_scale ** (1.0 / n_layers)
    params = {}
    for i in range(n_layers):
        init = math.log(math.expm1(1.0 / scale / filters[i + 1]))
        params[f"matrix{i}"] = torch.full(
            (cfg.channels, filters[i + 1], filters[i]), init,
            dtype=torch.float32)
        params[f"bias{i}"] = torch.rand(
            (cfg.channels, filters[i + 1], 1), generator=generator,
            dtype=torch.float32) - 0.5
        if i < n_layers - 1:
            params[f"factor{i}"] = torch.zeros(
                (cfg.channels, filters[i + 1], 1), dtype=torch.float32)
    params["quantiles"] = torch.tensor(
        [-cfg.init_scale, 0.0, cfg.init_scale],
        dtype=torch.float32).repeat(cfg.channels, 1, 1)
    return params


def n_layers(params: dict) -> int:
    return sum(1 for k in params if k.startswith("matrix"))


def _logits_cumulative(params: dict, x: torch.Tensor,
                       stop_gradient: bool) -> torch.Tensor:
    """Logit of the model CDF, evaluated pointwise.

    `x` has shape (channels, 1, N); returns the same shape. With
    ``stop_gradient`` the chain weights are frozen (the quantile aux loss
    trains only `quantiles`).
    """
    L = n_layers(params)
    logits = x
    for i in range(L):
        m, b = params[f"matrix{i}"], params[f"bias{i}"]
        if stop_gradient:
            m, b = m.detach(), b.detach()
        logits = torch.matmul(F.softplus(m), logits) + b
        if i < L - 1:
            f = params[f"factor{i}"]
            if stop_gradient:
                f = f.detach()
            logits = logits + torch.tanh(f) * torch.tanh(logits)
    return logits


def _chan_major(z: torch.Tensor) -> torch.Tensor:
    # (batch, channels) -> (channels, 1, batch)
    return z.transpose(0, 1)[:, None, :]


def _batch_major(v: torch.Tensor) -> torch.Tensor:
    # (channels, 1, batch) -> (batch, channels)
    return v[:, 0, :].transpose(0, 1)


def likelihood(params: dict, z: torch.Tensor) -> torch.Tensor:
    """P(round(Z) = z) under the factorized model; z shape (batch, channels)."""
    v = _chan_major(z.float())
    lower = _logits_cumulative(params, v - 0.5, stop_gradient=False)
    upper = _logits_cumulative(params, v + 0.5, stop_gradient=False)
    # evaluate on the side with smaller magnitude for stability (sign trick)
    sign = -torch.sign(lower + upper).detach()
    # d|D| = +1 at D = 0, as JAX's
    lik = abs_jax(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    return _batch_major(lik)


def medians(params: dict) -> torch.Tensor:
    """Per-channel distribution medians, shape (channels,)."""
    return params["quantiles"][:, 0, 1]


def quantize(params: dict, z: torch.Tensor, mode: str,
             noise: torch.Tensor | None = None):
    """'noise' (training surrogate: `z + noise`), 'dequantize' (eval), or
    'symbols' (int32). The noise is passed in, so a caller (or a test) that
    holds the same U(-0.5, 0.5) draws gets the same result."""
    z = z.float()
    if mode == "noise":
        if noise is None:
            raise ValueError("mode='noise' needs the noise tensor")
        return z + noise
    med = medians(params)[None, :]
    if mode == "dequantize":
        return torch.round(z - med) + med
    if mode == "symbols":
        return torch.round(z - med).to(torch.int32)
    raise ValueError(f"unknown quantize mode {mode}")


def forward(params: dict, z: torch.Tensor, *, training: bool,
            generator: torch.Generator | None = None):
    """Noise-quantize (train) / round-to-median (eval) + likelihood.

    Returns (z_hat, likelihoods), both (batch, channels).
    """
    noise = None
    if training:
        if generator is None:
            raise ValueError("training=True needs a generator for the noise")
        # U(-0.5, 0.5), drawn from the caller's generator (the global
        # batch's draw in a data-parallel step)
        noise = mesh.global_draw(
            lambda s: torch.rand(s, generator=generator, dtype=torch.float32,
                                 device=z.device), tuple(z.shape)) - 0.5
    z_hat = quantize(params, z, "noise" if training else "dequantize", noise)
    lik = likelihood(params, z_hat)
    lik = lower_bound(lik, LIKELIHOOD_BOUND)
    return z_hat, lik


def aux_loss(params: dict, tail_mass: float = TAIL_MASS) -> torch.Tensor:
    """Quantile loss: push quantiles to the (tail, median, 1-tail) points."""
    logits = _logits_cumulative(params, params["quantiles"],
                                stop_gradient=True)
    t = math.log(2.0 / tail_mass - 1.0)
    target = torch.tensor([-t, 0.0, t], dtype=torch.float32,
                          device=logits.device)
    return torch.sum(abs_jax(logits - target[None, None, :]))


# ---------------------------------------------------------------------------
# Host-side CDF table construction (CompressAI's `update()`). Produces the
# integer tables consumed by the rANS codec.
# ---------------------------------------------------------------------------


def to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _np_logits_cumulative(params_np: dict, x: np.ndarray) -> np.ndarray:
    L = sum(1 for k in params_np if k.startswith("matrix"))
    logits = x
    for i in range(L):
        m = np.logaddexp(0.0, params_np[f"matrix{i}"])  # softplus
        logits = np.einsum("coi,cin->con", m, logits) + params_np[f"bias{i}"]
        if i < L - 1:
            logits = logits + np.tanh(params_np[f"factor{i}"]) * np.tanh(logits)
    return logits


def _np_sigmoid(x):
    return 0.5 * (1.0 + np.tanh(0.5 * x))


@dataclasses.dataclass
class CdfTables:
    """Quantized CDF tables for the rANS codec (one row per channel/index)."""

    quantized_cdf: np.ndarray  # (n, max_len) int32
    cdf_length: np.ndarray     # (n,) int32
    offset: np.ndarray         # (n,) int32


def build_cdf_tables(params, arithmetic: str = "float64") -> CdfTables:
    """Build per-channel quantized CDFs from the learned density.

    `arithmetic` picks the float pipeline the pmf is evaluated in, as in
    the JAX package:

    * ``"float64"`` (default) — numpy float64, best-conditioned; use for
      self-consistent encode/decode within this framework.
    * ``"compressai"`` — torch float32 on the host, op for op the arithmetic
      of CompressAI's ``EntropyBottleneck.update()``. fp32 roundoff decides
      a handful of lround boundaries per checkpoint, and rANS needs EXACT
      table equality to cross-decode, so interop with reference-encoded
      streams must build tables this way.
    """
    if arithmetic == "compressai":
        return _compressai_fp32_tables(params)
    if arithmetic != "float64":
        raise ValueError(f"unknown arithmetic={arithmetic!r}")
    from .rans import pmf_to_quantized_cdf

    p = {k: to_numpy(v).astype(np.float64) for k, v in params.items()}
    q = p["quantiles"]  # (C, 1, 3)
    med = q[:, 0, 1]
    minima = np.maximum(np.ceil(med - q[:, 0, 0]).astype(np.int64), 0)
    maxima = np.maximum(np.ceil(q[:, 0, 2] - med).astype(np.int64), 0)

    pmf_start = med - minima
    pmf_length = (maxima + minima + 1).astype(np.int64)
    max_length = int(pmf_length.max())

    samples = np.arange(max_length, dtype=np.float64)[None, None, :] \
        + pmf_start[:, None, None]
    lower = _np_logits_cumulative(p, samples - 0.5)
    upper = _np_logits_cumulative(p, samples + 0.5)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_np_sigmoid(sign * upper) - _np_sigmoid(sign * lower))[:, 0, :]
    tail = _np_sigmoid(lower[:, 0, 0]) + _np_sigmoid(-upper[:, 0, -1])

    C = pmf.shape[0]
    cdf = np.zeros((C, max_length + 2), dtype=np.int32)
    for c in range(C):
        prob = np.concatenate([pmf[c, : pmf_length[c]], [tail[c]]])
        row = pmf_to_quantized_cdf(prob)
        cdf[c, : len(row)] = row
    return CdfTables(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=(-minima).astype(np.int32),
    )


def _compressai_fp32_tables(params) -> CdfTables:
    """Torch-fp32 table build, bit-faithful to CompressAI's update().

    Op for op the JAX package's `_compressai_fp32_tables` (CompressAI
    1.1.x's EntropyBottleneck.update() + _pmf_to_cdf): float32 throughout
    on the host CPU, torch's own softplus/tanh/sigmoid kernels, the
    sign-conditional sigmoid difference, int support bounds from fp32 ceil.
    Any change in how this computes breaks cross-decoding.
    """
    from .rans import pmf_to_quantized_cdf

    tp = {k: torch.as_tensor(to_numpy(v), dtype=torch.float32)
          for k, v in params.items()}
    n = sum(1 for k in tp if k.startswith("matrix"))

    def logits(x):
        u = x
        for k in range(n):
            m = torch.nn.functional.softplus(tp[f"matrix{k}"])
            u = torch.matmul(m, u) + tp[f"bias{k}"]
            if k < n - 1:
                u = u + torch.tanh(tp[f"factor{k}"]) * torch.tanh(u)
        return u

    q = tp["quantiles"]
    med = q[:, 0, 1]
    minima = torch.clamp(torch.ceil(med - q[:, 0, 0]).int(), min=0)
    maxima = torch.clamp(torch.ceil(q[:, 0, 2] - med).int(), min=0)
    pmf_start = med - minima.float()
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = torch.arange(max_length).float()[None, None, :] \
        + pmf_start[:, None, None]
    half = float(0.5)
    lower = logits(samples - half)
    upper = logits(samples + half)
    sign = -torch.sign(lower + upper)
    pmf = torch.abs(torch.sigmoid(sign * upper)
                    - torch.sigmoid(sign * lower))[:, 0, :]
    tail = torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])

    n_ch = pmf.shape[0]
    cdf = np.zeros((n_ch, max_length + 2), dtype=np.int32)
    for c in range(n_ch):
        # .tolist() widens the exact fp32 values like CompressAI's
        # prob.tolist() -> vector<float> boundary (x*65536 is exact either
        # way: power-of-two scaling does not round)
        prob = pmf[c, : int(pmf_length[c])].tolist() + [float(tail[c])]
        row = pmf_to_quantized_cdf(np.asarray(prob, np.float64))
        cdf[c, : len(row)] = row
    return CdfTables(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).numpy().astype(np.int32),
        offset=(-minima).numpy().astype(np.int32),
    )
