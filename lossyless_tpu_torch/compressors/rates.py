"""Rate estimators: learn the bit-rate of Z, and code it for real.

Counterpart of `lossyless_tpu/compressors/rates.py`: `RateConfig` (all of
it), `EntropyBottleneckModule`, `_AffineZ`, `HRateFactorizedPrior`,
`HRateHyperprior`, `HRateHyperpriorSpatial`, `Lossless` with
`lossless_bits`, `MIRate`, `make_rate_estimator`, and the host coders
`FactorizedCoder`, `HyperpriorCoder` and `SpatialHyperpriorCoder`. Each
estimator's
`forward(z, p_zlx, *, training, ...)` returns `(z_hat, rates_in_nats,
logs)`; likelihoods are fp32.

Training noise is U(-0.5, 0.5), drawn from the caller's `torch.Generator`
or passed in as `noise` (the parity tests hand both frameworks the same
draws). The hyperprior takes two draws, the side bottleneck's and then the
Gaussian conditional's (JAX splits the rate's key into these two), so its
`noise` is the pair; the spatial hyperprior's is its inner hyperprior's
pair, in the folded layout ((B * H * W, side), (B * H * W, C)). `MI`
draws nothing.
"""

from __future__ import annotations

import dataclasses
import io
import math

import numpy as np
import torch
from torch import nn

from ..coding import eb_kernel
from ..coding import entropy_bottleneck as eb
from ..coding import gaussian_conditional as gc
from ..coding.rans import RansCodec
from ..core import mesh
from ..core.math import LOG2, lower_bound
from ..nn.mlp import MLP
from .distributions import DiagGaussian, detach, kl_unit_gaussian


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
    """U(-0.5, 0.5) fp32 noise from `generator` (on `device`); in a
    data-parallel step, this rank's rows of the global batch's draw
    (`core.mesh.global_draw`)."""
    if generator is None:
        raise ValueError("training needs a generator (or the noise tensor)")
    return mesh.global_draw(
        lambda s: torch.rand(s, generator=generator, dtype=torch.float32,
                             device=device), tuple(shape)) - 0.5


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


class HRateHyperprior(nn.Module):
    """Mean-scale hyperprior over Z: an MLP side encoder, the side latent
    coded by an entropy bottleneck, and an MLP from the quantized side
    latent to the per-element Gaussian's scale (and mean)."""

    def __init__(self, z_dim: int, cfg: RateConfig = RateConfig(
            mode="H_hyper"), generator: torch.Generator | None = None):
        super().__init__()
        self.z_dim, self.cfg = z_dim, cfg
        side = cfg.side_z_dim or max(10, z_dim // cfg.factor_dim)
        self.side_z_dim = side
        self.affine = _AffineZ(z_dim)
        self.entropy_bottleneck = EntropyBottleneckModule(
            side, cfg.eb_filters, cfg.eb_init_scale,
            use_pallas=cfg.eb_use_pallas, generator=generator)
        hid = max(z_dim, 256)
        self.side_encoder = MLP(z_dim, side, hid_dim=hid, n_hid_layers=2,
                                generator=generator)
        out = z_dim * 2 if cfg.is_pred_mean else z_dim
        self.z_encoder = MLP(side, out, hid_dim=hid, n_hid_layers=2,
                             generator=generator)

    def _gaussian_params(self, side_z_hat, training: bool):
        gp = self.z_encoder(side_z_hat, training=training)
        if self.cfg.is_pred_mean:
            scales, means = gp.chunk(2, dim=-1)
            return scales, means
        return gp, None

    def forward(self, z, p_zlx=None, *, training: bool, noise=None,
                generator=None, step: int = 0, detach_rate: bool = False):
        """`noise` is the pair (side, z) of U(-0.5, 0.5) draws; without it
        training draws them from `generator` in that order. With
        `detach_rate` the rates see a detached z while z_hat stays live,
        one evaluation of the hyperprior (see HRateFactorizedPrior)."""
        z_in = self.affine.process_in(z)
        if training and noise is None:
            noise = (uniform_noise((z.shape[0], self.side_z_dim), generator,
                                   z_in.device),
                     uniform_noise(z_in.shape, generator, z_in.device))
        n_side, n_z = noise if training else (None, None)
        z_rate = self.affine.process_in(z.detach()) if detach_rate else z_in

        side_z = self.side_encoder(z_rate, training=training)
        side_z_hat, q_s = self.entropy_bottleneck(side_z, training=training,
                                                  noise=n_side)
        scales, means = self._gaussian_params(side_z_hat, training)
        z_hat, q_zls = gc.forward(z_rate, scales, means, training=training,
                                  noise=n_z)
        if detach_rate:
            z_hat = gc.quantize(z_in, "noise" if training else "dequantize",
                                means, n_z)

        neg_log_q_s = -torch.log(q_s).sum(-1)
        neg_log_q_zls = -torch.log(q_zls).sum(-1)
        neg_log_q_zs = neg_log_q_s + neg_log_q_zls
        logs = {"H_q_ZlS": _nats_to_bits_mean(neg_log_q_zls),
                "H_q_Z": _nats_to_bits_mean(neg_log_q_zs),
                "H_q_S": _nats_to_bits_mean(neg_log_q_s),
                "H_ZlX": 0.0}
        return self.affine.process_out(z_hat), neg_log_q_zs, logs

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


def _side(z_dim: int, n_channels: int) -> int:
    """The side of the square spatial latent of `z_dim` = C * side^2."""
    side = math.isqrt(z_dim // n_channels)
    if side * side * n_channels != z_dim:
        raise ValueError("H_spatial needs a square spatial latent")
    return side


def fold_spatial(z, n_channels: int):
    """(B, C * H * W), stored channel-major (einops' 'b (c h w)'), ->
    (B * H * W, C): the positions become rows. Tensors or numpy arrays."""
    b = z.shape[0]
    s2 = z.shape[1] // n_channels
    return z.reshape(b, n_channels, s2).swapaxes(1, 2).reshape(
        b * s2, n_channels)


def unfold_spatial(zs, b: int):
    """`fold_spatial`'s inverse: (B * H * W, C) -> (B, C * H * W)."""
    c = zs.shape[1]
    return zs.reshape(b, -1, c).swapaxes(1, 2).reshape(b, -1)


class HRateHyperpriorSpatial(nn.Module):
    """The hyperprior at each spatial position of a BALLE latent: the
    flattened latent (B, C * H * W) is folded to (B * H * W, C), the
    positions become rows of the inner `HRateHyperprior` over C
    channels, and the rates are summed back over a sample's positions
    (the logs, means over rows, scaled by H * W)."""

    def __init__(self, z_dim: int, n_channels: int,
                 cfg: RateConfig = RateConfig(mode="H_spatial"),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.z_dim, self.n_channels, self.cfg = z_dim, n_channels, cfg
        self.side_dim = _side(z_dim, n_channels)
        self.inner = HRateHyperprior(n_channels, cfg, generator)

    def forward(self, z, p_zlx=None, *, training: bool, noise=None,
                generator=None, step: int = 0, detach_rate: bool = False):
        b, n_pos = z.shape[0], self.side_dim ** 2
        z_hat, rates, logs = self.inner(
            fold_spatial(z, self.n_channels), p_zlx, training=training,
            noise=noise, generator=generator, step=step,
            detach_rate=detach_rate)
        return (unfold_spatial(z_hat, b), rates.reshape(b, n_pos).sum(-1),
                {k: v * n_pos for k, v in logs.items()})

    def aux_loss(self):
        return self.inner.aux_loss()


class Lossless(nn.Module):
    """Lossless float coding baseline: z passes through. The rate term is a
    gradient-connected zero, as in JAX; the gzip'd bits are computed on
    the host by `lossless_bits` during evaluation."""

    def __init__(self, z_dim: int):
        super().__init__()
        self.z_dim = z_dim

    def forward(self, z, p_zlx=None, *, training: bool, noise=None,
                generator=None, step: int = 0, detach_rate: bool = False):
        return z, z.mean(-1) * 0.0, {}


class MIRate(nn.Module):
    """Upper bound of I[Z, X]: KL[p(Z|x) || N(0, I)] for a Gaussian
    encoder, the cross-entropy -log N(z; 0, I) for a deterministic one. z
    passes through; nothing is drawn."""

    def __init__(self, z_dim: int):
        super().__init__()
        self.z_dim = z_dim

    def forward(self, z, p_zlx, *, training: bool, noise=None,
                generator=None, step: int = 0, detach_rate: bool = False):
        """With `detach_rate` the rates and their logs see a detached z and
        p(Z|x)."""
        z_rate, p_rate = (z.detach(), detach(p_zlx)) if detach_rate \
            else (z, p_zlx)
        if isinstance(p_rate, DiagGaussian):
            kl = kl_unit_gaussian(p_rate)
            h_zlx = p_rate.entropy()
        else:
            kl = 0.5 * (z_rate ** 2 + math.log(2 * math.pi)).sum(-1)
            h_zlx = torch.zeros(z.shape[0], device=z.device)
        logs = {"I_q_ZX": _nats_to_bits_mean(kl),
                "H_ZlX": _nats_to_bits_mean(h_zlx)}
        logs["H_q_Z"] = logs["I_q_ZX"] + logs["H_ZlX"]
        return z, kl, logs


def lossless_bits(z_np: np.ndarray) -> float:
    """gzip'd bits a sample of the raw float representation."""
    with io.BytesIO() as f:
        np.savez_compressed(f, np.asarray(z_np))
        return f.getbuffer().nbytes * 8 / z_np.shape[0]


def make_rate_estimator(z_dim: int, cfg: RateConfig,
                        generator: torch.Generator | None = None):
    if cfg.mode == "H_factorized":
        return HRateFactorizedPrior(z_dim, cfg, generator)
    if cfg.mode == "H_hyper":
        return HRateHyperprior(z_dim, cfg, generator)
    if cfg.mode == "lossless":
        return Lossless(z_dim)
    if cfg.mode == "MI":
        return MIRate(z_dim)
    if cfg.mode == "H_spatial":
        return HRateHyperpriorSpatial(z_dim, cfg.n_channels, cfg, generator)
    raise ValueError(f"unknown rate mode={cfg.mode}")


# ---------------------------------------------------------------------------
# Host-side real coding, on the learned parameters
# ---------------------------------------------------------------------------


def _host(v) -> np.ndarray:
    return eb.to_numpy(v).astype(np.float32)


class FactorizedCoder:
    """compress/decompress for HRateFactorizedPrior parameters: a dict
    {"affine": {scaling, biasing}, "entropy_bottleneck": {...}} of arrays
    or tensors. Host only."""

    def __init__(self, params: dict):
        self.scaling = _host(params["affine"]["scaling"])
        self.biasing = _host(params["affine"]["biasing"])
        ebp = {k: _host(v) for k, v in params["entropy_bottleneck"].items()}
        tables = eb.build_cdf_tables(ebp)
        self.codec = RansCodec(tables.quantized_cdf, tables.cdf_length,
                               tables.offset)
        self.medians = eb.medians(ebp)
        self.indexes = np.arange(len(self.medians), dtype=np.int32)

    @classmethod
    def from_module(cls, rate: HRateFactorizedPrior) -> "FactorizedCoder":
        return cls({"affine": {"scaling": rate.affine.scaling,
                               "biasing": rate.affine.biasing},
                    "entropy_bottleneck": rate.entropy_bottleneck.eb_params})

    def process_in(self, z):
        return (np.asarray(z, np.float32) + self.biasing) \
            * np.exp(self.scaling)

    def process_out(self, z_hat):
        return z_hat / np.exp(self.scaling) - self.biasing

    def compress(self, z) -> list[bytes]:
        z_in = self.process_in(z)
        symbols = np.round(z_in - self.medians[None]).astype(np.int32)
        return self.codec.encode_batch(symbols, self.indexes)

    def decompress(self, streams: list[bytes]) -> np.ndarray:
        symbols = self.codec.decode_batch(streams, self.indexes)
        z_hat = symbols.astype(np.float32) + self.medians[None]
        return self.process_out(z_hat)


def _host_mlp_forward(params: dict, x: np.ndarray) -> np.ndarray:
    """NumPy forward of the rate estimators' `MLP` (identity norm, relu, no
    dropout): Dense_0..Dense_{n-1}, relu between all but the last. fp32.

    Only a plain Dense stack can be run here: any other entry (a norm, a
    missing Dense index) raises rather than decode with wrong Gaussians."""
    other = sorted(k for k in params if not k.startswith("Dense_"))
    if other:
        raise ValueError(f"host MLP forward takes Dense_* layers only, got "
                         f"{other}")
    n_dense = len(params)
    if sorted(params) != sorted(f"Dense_{i}" for i in range(n_dense)):
        raise ValueError(f"Dense layers must be Dense_0..Dense_{n_dense - 1}"
                         f", got {sorted(params)}")
    x = np.asarray(x, np.float32).reshape(len(x), -1)
    for i in range(n_dense):
        p = params[f"Dense_{i}"]
        x = x @ np.asarray(p["kernel"], np.float32) \
            + np.asarray(p["bias"], np.float32)
        if i < n_dense - 1:
            x = np.maximum(x, 0.0, out=x)
    return x


def _host_build_indexes(scales: np.ndarray,
                        scale_table: np.ndarray) -> np.ndarray:
    """NumPy `gc.build_indexes`: index of the smallest table scale >= each
    element's scale."""
    st = np.asarray(scale_table[:-1], np.float32)
    s = np.maximum(np.asarray(scales, np.float32), np.float32(scale_table[0]))
    return np.searchsorted(st, s, side="left").astype(np.int32)


def _nested(state: dict) -> dict:
    """{"Dense_0.kernel": t, ...} -> {"Dense_0": {"kernel": array}, ...}."""
    out: dict = {}
    for k, v in state.items():
        layer, name = k.rsplit(".", 1)
        out.setdefault(layer, {})[name] = _host(v)
    return out


class HyperpriorCoder:
    """compress/decompress for HRateHyperprior.

    Two streams per sample: the side latent coded by its entropy
    bottleneck, then the main latent coded against per-element
    conditional Gaussians whose scale and mean come from the decoded side
    latent. The sender runs the affine and the side encoder on the
    module's device (they take the whole latent batch); everything the
    receiver needs (the z-encoder MLP, the index build, the output affine)
    runs on the host in numpy, and the sender uses the same host functions
    for the indexes and means, so sender and receiver agree bit for bit.
    """

    def __init__(self, module: HRateHyperprior):
        self.module = module
        ebp = {k: _host(v)
               for k, v in module.entropy_bottleneck.eb_params.items()}
        side_tables = eb.build_cdf_tables(ebp)
        self.side_codec = RansCodec(side_tables.quantized_cdf,
                                    side_tables.cdf_length, side_tables.offset)
        self.side_medians = eb.medians(ebp)
        self.side_indexes = np.arange(len(self.side_medians), dtype=np.int32)

        self.scale_table = gc.default_scale_table()
        z_tables = gc.build_cdf_tables(self.scale_table)
        self.z_codec = RansCodec(z_tables.quantized_cdf, z_tables.cdf_length,
                                 z_tables.offset)
        self._z_encoder_np = _nested(module.z_encoder.state_dict())
        self._out_scale_np = np.exp(_host(module.affine.scaling))
        self._biasing_np = _host(module.affine.biasing)
        self._is_pred_mean = module.cfg.is_pred_mean

    def _indexes_means(self, side_z_hat_np):
        gp = _host_mlp_forward(self._z_encoder_np, side_z_hat_np)
        if self._is_pred_mean:
            scales, means = np.split(gp, 2, axis=-1)
        else:
            scales, means = gp, None
        return _host_build_indexes(scales, self.scale_table), means

    @torch.no_grad()
    def _sender(self, z, side_symbols=None):
        m = self.module
        z = torch.as_tensor(np.asarray(z, np.float32),
                            device=m.affine.scaling.device)
        z_in = m.affine.process_in(z)
        if side_symbols is None:
            side_z = m.side_encoder(z_in, training=False).cpu().numpy()
            side_symbols = np.round(side_z - self.side_medians[None]) \
                .astype(np.int32)
        z_in = z_in.cpu().numpy()
        # the receiver sees the quantized side latent
        side_z_hat = side_symbols.astype(np.float32) + self.side_medians[None]
        indexes, means = self._indexes_means(side_z_hat)
        z_symbols = np.round(z_in - (means if means is not None else 0.0)) \
            .astype(np.int32)
        return z_symbols, side_symbols, indexes

    def encode_symbols(self, z, side_symbols=None):
        """(main-latent symbols, side symbols) the sender codes. Given
        `side_symbols`, the main latent is quantized against those (another
        sender's side information) instead of its own."""
        return self._sender(z, side_symbols)[:2]

    def dequantize(self, z_symbols, side_symbols) -> np.ndarray:
        """The receiver's z_hat from the two symbol arrays (host only)."""
        side_z_hat = side_symbols.astype(np.float32) + self.side_medians[None]
        _, means = self._indexes_means(side_z_hat)
        z_hat = z_symbols.astype(np.float32) + \
            (means if means is not None else 0.0)
        return z_hat / self._out_scale_np - self._biasing_np

    def compress(self, z) -> list[list[bytes]]:
        z_symbols, side_symbols, indexes = self._sender(z)
        side_streams = self.side_codec.encode_batch(side_symbols,
                                                    self.side_indexes)
        z_streams = self.z_codec.encode_batch_varidx(z_symbols, indexes)
        return [z_streams, side_streams]

    def decompress(self, all_strings) -> np.ndarray:
        z_streams, side_streams = all_strings
        side_symbols = self.side_codec.decode_batch(side_streams,
                                                    self.side_indexes)
        side_z_hat = side_symbols.astype(np.float32) + self.side_medians[None]
        indexes, _ = self._indexes_means(side_z_hat)
        z_symbols = self.z_codec.decode_batch_varidx(z_streams, indexes)
        return self.dequantize(z_symbols, side_symbols)


class SpatialHyperpriorCoder:
    """compress/decompress for HRateHyperpriorSpatial: the latent folded
    as in training (`fold_spatial`), one hyperprior message a position
    coded by the inner `HyperpriorCoder`; the streams are the inner
    coder's, a sample's positions in scan order."""

    def __init__(self, module: HRateHyperpriorSpatial):
        self.module = module
        self.n_channels = module.n_channels
        self.side_dim = module.side_dim
        self.inner = HyperpriorCoder(module.inner)

    def compress(self, z) -> list[list[bytes]]:
        return self.inner.compress(fold_spatial(np.asarray(z, np.float32),
                                                self.n_channels))

    def decompress(self, all_strings, batch_size: int | None = None):
        zs = self.inner.decompress(all_strings)
        b = batch_size or len(all_strings[0]) // self.side_dim ** 2
        return unfold_spatial(zs, b)
