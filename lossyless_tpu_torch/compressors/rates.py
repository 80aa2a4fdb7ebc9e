"""Rate estimators: the factorized prior of the hub compressor.

Counterpart of `lossyless_tpu/compressors/rates.py`, factorized part:
`RateConfig` (all of it), `EntropyBottleneckModule`, `_AffineZ`,
`HRateFactorizedPrior` and `make_rate_estimator`. Each estimator's
`forward(z, p_zlx, *, training, ...)` returns `(z_hat, rates_in_nats,
logs)`; likelihoods are fp32.

Training noise is U(-0.5, 0.5), drawn from the caller's `torch.Generator`
or passed in as `noise` (the parity tests hand both frameworks the same
draws). The other modes (`lossless`, `MI`, `H_hyper`, `H_spatial`) are not
ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..coding import eb_kernel
from ..coding import entropy_bottleneck as eb
from ..core.math import lower_bound

LOG2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True)
class RateConfig:
    mode: str = "H_factorized"          # lossless|MI|H_factorized|H_hyper|H_spatial
    eb_filters: tuple = (3, 3, 3)
    eb_init_scale: float = 10.0
    # run the likelihood on the hand-written kernel K3 (coding/eb_kernel.py)
    # instead of the reference chain
    eb_use_pallas: bool = False
    side_z_dim: int | None = None
    factor_dim: int = 5
    is_pred_mean: bool = True
    is_endToEnd: bool = True
    warmup_steps: int = 0
    warmup_k_epochs: int = 0
    n_channels: int | None = None       # for H_spatial: latent channels


def uniform_noise(shape, generator: torch.Generator | None,
                  device) -> torch.Tensor:
    """U(-0.5, 0.5) fp32 noise from `generator` (on `device`)."""
    if generator is None:
        raise ValueError("training needs a generator (or the noise tensor)")
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device) - 0.5


class EntropyBottleneckModule(nn.Module):
    """The functional entropy bottleneck's params as module parameters,
    named as in the CompressAI layout (`matrix{i}`, `bias{i}`, `factor{i}`,
    `quantiles`)."""

    def __init__(self, channels: int, filters: tuple = (3, 3, 3),
                 init_scale: float = 10.0, use_pallas: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_pallas = use_pallas
        template = eb.init_params(
            eb.EBConfig(channels, tuple(filters), init_scale),
            generator or torch.Generator().manual_seed(0))
        self._keys = tuple(template)
        for k, v in template.items():
            self.register_parameter(k, nn.Parameter(v))

    @property
    def eb_params(self) -> dict:
        return {k: getattr(self, k) for k in self._keys}

    def likelihood(self, z_hat: torch.Tensor) -> torch.Tensor:
        """Floored likelihood of already noised/rounded values."""
        if self.use_pallas:
            lik = eb_kernel.likelihood(self.eb_params, z_hat)
        else:
            lik = eb.likelihood(self.eb_params, z_hat)
        return lower_bound(lik, eb.LIKELIHOOD_BOUND)

    def forward(self, z, *, training: bool, noise=None, generator=None):
        if training and noise is None:
            noise = uniform_noise(z.shape, generator, z.device)
        z_hat = eb.quantize(self.eb_params, z,
                            "noise" if training else "dequantize", noise)
        return z_hat, self.likelihood(z_hat)

    def aux_loss(self):
        return eb.aux_loss(self.eb_params)


class _AffineZ(nn.Module):
    """Per-dim (z + bias) * exp(scale) preconditioner."""

    def __init__(self, z_dim: int):
        super().__init__()
        self.scaling = nn.Parameter(torch.zeros(z_dim))
        self.biasing = nn.Parameter(torch.zeros(z_dim))

    def process_in(self, z):
        return (z.float() + self.biasing) * torch.exp(self.scaling)

    def process_out(self, z_hat):
        return (z_hat / torch.exp(self.scaling)) - self.biasing


def _nats_to_bits_mean(x):
    return x.mean() / LOG2


class HRateFactorizedPrior(nn.Module):
    """Factorized-prior entropy coding of Z."""

    def __init__(self, z_dim: int, cfg: RateConfig = RateConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.z_dim, self.cfg = z_dim, cfg
        self.affine = _AffineZ(z_dim)
        self.entropy_bottleneck = EntropyBottleneckModule(
            z_dim, cfg.eb_filters, cfg.eb_init_scale,
            use_pallas=cfg.eb_use_pallas, generator=generator)

    def forward(self, z, p_zlx=None, *, training: bool, noise=None,
                generator=None, step: int = 0, detach_rate: bool = False):
        """With `detach_rate` the rates (and their log) see a detached z,
        while z_hat stays live: the `is_endToEnd=False` pair of JAX calls
        (`compressor.py:201-208`, the same noise in both) in one likelihood
        evaluation, since the two forwards are equal."""
        z_in = self.affine.process_in(z)
        if training and noise is None:
            noise = uniform_noise(z_in.shape, generator, z_in.device)
        mode = "noise" if training else "dequantize"
        eb_params = self.entropy_bottleneck.eb_params
        z_hat = eb.quantize(eb_params, z_in, mode, noise)
        z_rate = z_hat
        if detach_rate:
            z_rate = eb.quantize(eb_params,
                                 self.affine.process_in(z.detach()), mode,
                                 noise)
        q_z = self.entropy_bottleneck.likelihood(z_rate)
        neg_log_q_z = -torch.log(q_z).sum(-1)
        logs = {"H_q_Z": _nats_to_bits_mean(neg_log_q_z), "H_ZlX": 0.0}
        return self.affine.process_out(z_hat), neg_log_q_z, logs

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


def make_rate_estimator(z_dim: int, cfg: RateConfig,
                        generator: torch.Generator | None = None):
    if cfg.mode == "H_factorized":
        return HRateFactorizedPrior(z_dim, cfg, generator)
    if cfg.mode in ("lossless", "MI", "H_hyper", "H_spatial"):
        raise NotImplementedError(
            f"rate mode {cfg.mode!r} is not ported yet (ROADMAP queue 1 "
            f"item 5)")
    raise ValueError(f"unknown rate mode={cfg.mode}")
