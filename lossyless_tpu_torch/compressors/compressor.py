"""The learnable compressor: encoder + rate + distortion.

Counterpart of `lossyless_tpu/compressors/compressor.py`. One `step`
computes the combined objective

    loss = lambda * distortion + beta_t * rate   (annealed-beta trick)
         + online probe loss on the detached z + coder quantile aux loss

and the trainer (`train/state.py`) splits the parameters into optimizer
groups by path. The encoder is the CLIP tower, an MLP, a ResNet, a
CNN or BALLE; the rate any of the ported estimators; the distortion direct,
contrastive or lossy Z.

Contrastive recipes encode two views (x and its positive, `aux_target`).
The default two-pass form encodes the positive after the anchor, with the
same modules: a BatchNorm of the encoder updates its running statistics
on the anchor's batch, then on the positive's, as flax does in one apply.
`concat_views` runs one 2B-batch forward instead (joint BatchNorm
statistics). Only the anchor's rates enter the loss.

Every random draw of a step can be passed in, as the parity tests pass
JAX's: `noise` (the rate's U(-0.5, 0.5) draws) and `eps` (the standard
normals of a Gaussian encoder's sample); in a two-view step each is the
pair (anchor's, positive's). Without them training draws from
`generator`.

Two differences of form from JAX, with the same updates:

* With `is_endToEnd=False` JAX calls the rate estimator twice with the
  same noise (live, and on `stop_gradient(z)`), and XLA merges the equal
  forwards. Here the estimator evaluates the likelihood once on the
  detached z (`detach_rate=True`), for the rates and their log, and keeps
  the live `z_hat` for the distortion.
* A frozen encoder (`frozen` names a path of it) runs under
  `torch.no_grad()`: JAX computes its gradients and zeroes them
  (`optax.set_to_zero`), XLA drops the dead work; here it is never built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
from torch import nn

from ..core import mesh
from ..core.annealer import Annealer
from ..core.math import LOG2
from ..nn.layers import merge_stats as _merge_stats
from ..nn.layers import params_from_flax as tree_params_from_flax
from ..nn.registry import get_architecture
from ..nn.vit import VisionTransformer, params_from_flax
from .distortions import (DistortionConfig, make_distortion_estimator,
                          prediction_loss)
from .distributions import from_suff_param, n_suff_params
from .rates import RateConfig, make_rate_estimator


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    arch: str = "mlp"
    z_dim: int = 128
    family: str = "deterministic"        # deterministic|diaggaussian
    arch_kwargs: dict = dataclasses.field(default_factory=dict)
    pretrained_path: str = ""


@dataclasses.dataclass(frozen=True)
class OnlineEvalConfig:
    is_online: bool = True
    arch: str = "mlp"
    arch_kwargs: dict = dataclasses.field(default_factory=dict)
    is_classification: bool = True


@dataclasses.dataclass(frozen=True)
class LossConfig:
    beta: float = 0.1
    factor_beta_rate: float = 1.0        # rate.factor_beta
    factor_beta_dist: float = 1.0        # distortion.factor_beta (=> lambda)
    beta_anneal: str = "linear"          # mode for the Annealer
    n_steps_anneal: int = 1000


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    encoder: EncoderConfig = EncoderConfig()
    rate: RateConfig = RateConfig()
    distortion: DistortionConfig = DistortionConfig()
    online: OnlineEvalConfig = OnlineEvalConfig()
    loss: LossConfig = LossConfig()
    in_shape: Sequence[int] = (2,)
    target_shape: int = 1
    aux_shape: Any = None


class CondEncoder(nn.Module):
    """Architecture -> sufficient stats -> conditional distribution."""

    def __init__(self, cfg: EncoderConfig, in_shape,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        shape = tuple(in_shape) if not isinstance(in_shape, int) \
            else in_shape
        self.mapper = get_architecture(
            cfg.arch, shape, cfg.z_dim * n_suff_params(cfg.family),
            generator=generator, **cfg.arch_kwargs)

    def forward(self, x, *, training: bool = False):
        # the tower has no batch statistics and takes no `training`
        suff = self.mapper(x) if isinstance(self.mapper, VisionTransformer) \
            else self.mapper(x, training=training)
        return from_suff_param(self.cfg.family, suff.float())


class OnlineEvaluator(nn.Module):
    """Probe on the detached z. Unlabeled samples (target -1) are masked
    out of the classification loss and accuracy; an all-unlabeled batch
    gives loss 0."""

    def __init__(self, cfg: OnlineEvalConfig, z_dim: int, target_shape,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.model = get_architecture(cfg.arch, z_dim, target_shape,
                                      generator=generator,
                                      **cfg.arch_kwargs)

    def forward(self, z, y, *, training: bool = False):
        y_hat = self.model(z.detach(), training=training)
        if self.cfg.is_classification:
            valid = y >= 0
            denom = valid.sum().clamp(min=1).float()
            per = prediction_loss(y_hat, y.clamp(min=0), True)
            loss = torch.where(valid, per, 0.0).sum() / denom
            hit = (y_hat.argmax(-1) == y).float()
            acc = torch.where(valid, hit, 0.0).sum() / denom
            logs = {"online_loss": loss, "online_acc": acc,
                    "online_err": 1.0 - acc}
        else:
            loss = prediction_loss(y_hat, y, False).mean()
            logs = {"online_loss": loss}
        return loss, logs


class LearnableCompressor(nn.Module):
    """Encoder p(Z|X), rate estimator and distortion estimator.

    `frozen` names module-path components whose subtree is frozen (as the
    trainer's `frozen_paths`): a frozen encoder runs without autograd.
    `generator` seeds the random init of the tower and the entropy
    bottleneck (the JAX package's numbers differ for the same seed; carry
    weights across with `compressor_params_from_flax`).
    """

    def __init__(self, cfg: CompressorConfig, frozen: tuple = (),
                 generator: torch.Generator | None = None):
        super().__init__()
        c = self.cfg = cfg
        self.frozen = tuple(frozen)
        generator = generator or torch.Generator().manual_seed(0)
        self.p_ZlX = CondEncoder(c.encoder, c.in_shape, generator)
        init = getattr(self.p_ZlX.mapper, "init_weights", None)
        if init is not None:
            init(generator)
        self.rate_estimator = make_rate_estimator(c.encoder.z_dim, c.rate,
                                                  generator)
        self.distortion_estimator = make_distortion_estimator(
            c.distortion, c.encoder.z_dim, c.aux_shape, generator)
        if c.online.is_online:
            self.online_evaluator = OnlineEvaluator(
                c.online, c.encoder.z_dim, c.target_shape, generator)
        # careful: this "beta" is 1/beta from the paper
        final_beta = c.loss.beta * c.loss.factor_beta_rate
        self.beta_annealer = Annealer(
            final_beta * 1e-5, final_beta,
            n_steps_anneal=max(1, c.loss.n_steps_anneal),
            mode=c.loss.beta_anneal)

    def _p_zlx(self, x, training: bool = False):
        if "p_ZlX" in self.frozen:
            with torch.no_grad():
                return self.p_ZlX(x, training=training)
        return self.p_ZlX(x, training=training)

    @staticmethod
    def _sample(p_zlx, generator, eps):
        """z from p(Z|x): the given normals, else a draw from `generator`,
        else the mean."""
        if eps is not None or generator is not None:
            return p_zlx.rsample(generator, eps)
        return p_zlx.mean

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, x):
        """x -> mean of p(Z|X) (the raw encoder forward, no quantization)."""
        return self.p_ZlX(x).mean

    def features(self, x, *, training: bool = False, generator=None,
                 noise=None):
        """x -> z_hat (with `generator`, z is sampled and noised)."""
        p_zlx = self._p_zlx(x, training)
        z = self._sample(p_zlx, generator, None)
        z_hat, _, _ = self.rate_estimator(z, p_zlx, training=training,
                                          generator=generator, noise=noise)
        return z_hat

    @torch.no_grad()
    def reconstruct(self, x, *, generator=None):
        """x -> the decoder's reconstruction (direct distortion only)."""
        z_hat = self.features(x, training=False, generator=generator)
        return self.distortion_estimator.reconstruct(z_hat)

    # -- training objective -------------------------------------------------

    def step(self, x, targets, aux_target, *, training: bool, step: int,
             generator: torch.Generator | None = None,
             noise=None, eps=None, is_rate_only: bool = False):
        """One RD step. Returns (loss, logs).

        `noise` and `eps` are the step's draws (the module docstring); a
        two-view step takes each as the pair (anchor's, positive's), and
        `concat_views` concatenates each pair into the 2B batch's.
        """
        c = self.cfg
        fuse_views = (c.distortion.mode == "contrastive"
                      and not c.distortion.is_already_featurized
                      and c.distortion.concat_views)
        # a data-parallel step's draws over the two views' 2B batch
        with mesh.views(2 if fuse_views else 1):
            return self._step(x, targets, aux_target, training=training,
                              step=step, generator=generator, noise=noise,
                              eps=eps, is_rate_only=is_rate_only)

    def _step(self, x, targets, aux_target, *, training: bool, step: int,
              generator, noise, eps, is_rate_only: bool):
        c = self.cfg
        is_two_view = (c.distortion.mode == "contrastive"
                       and not c.distortion.is_already_featurized)
        fuse_views = is_two_view and c.distortion.concat_views
        if is_two_view:
            if not all(d is None or isinstance(d, (tuple, list))
                       for d in (noise, eps)):
                raise ValueError("a two-view step takes noise and eps as "
                                 "(anchor's, positive's) pairs")
            noise, noise_pos = noise if noise is not None else (None, None)
            eps, eps_pos = eps if eps is not None else (None, None)
        enc_in = x
        if fuse_views:
            enc_in = torch.cat([x, aux_target])
            noise, eps = _cat_draws(noise, noise_pos), _cat_draws(eps,
                                                                  eps_pos)

        p_zlx = self._p_zlx(enc_in, training)
        z = self._sample(p_zlx, generator, eps)
        # the rate trains without backprop into the encoder, always or for
        # the first warmup_steps
        detach_rate = not c.rate.is_endToEnd or step < c.rate.warmup_steps
        z_hat, rates, r_logs = self.rate_estimator(
            z, p_zlx, training=training, noise=noise, generator=generator,
            step=step, detach_rate=detach_rate)
        if fuse_views:
            # the positive's rates are dropped, as in the two-pass form
            b = x.shape[0]
            z_hat, z_pos_hat, rates = z_hat[:b], z_hat[b:], rates[:b]

        if is_rate_only:
            r_logs = dict(r_logs)
            r_logs["rate"] = rates.mean() / LOG2
            return rates.mean(), r_logs

        if fuse_views:
            dist_target = z_pos_hat
        elif is_two_view:
            # the positive view through the same encoder and rate
            p_pos = self._p_zlx(aux_target, training)
            z_pos = self._sample(p_pos, generator, eps_pos)
            dist_target, _, _ = self.rate_estimator(
                z_pos, p_pos, training=training, noise=noise_pos,
                generator=generator, step=step)
        else:
            dist_target = aux_target

        distortions, d_logs = self.distortion_estimator(
            z_hat, dist_target, p_zlx, training=training)

        loss, logs = self._rd_loss(rates, distortions, step)
        logs.update(r_logs)
        logs.update(d_logs)
        logs.update(zmin=z_hat.min(), zmax=z_hat.max(), zmean=z_hat.mean())

        # online probe (own optimizer group; its input is detached)
        if c.online.is_online and targets is not None:
            online_loss, online_logs = self.online_evaluator(
                z_hat, targets, training=training)
            loss = loss + online_loss
            logs.update(online_logs)

        # coder aux loss (quantile optimizer group)
        if hasattr(self.rate_estimator, "aux_loss"):
            aux = self.rate_estimator.aux_loss()
            loss = loss + aux
            logs["coder_loss"] = aux
        return loss, logs

    def _rd_loss(self, rates, distortions, step: int):
        """distortion + beta*rate with the annealed-beta gradient trick."""
        c = self.cfg.loss
        rates = rates.float()
        distortions = distortions.float()

        curr_beta = self.beta_annealer(step)
        final_beta = c.beta * c.factor_beta_rate
        labda = 1.0 / c.factor_beta_dist

        loose_loss = (labda * distortions + final_beta * rates).mean() \
            .detach()
        rate = rates.mean()
        distortion = distortions.mean()

        # gradients from the annealed beta; the reported value uses the
        # final beta
        beta_rate = curr_beta * rate
        beta_rate = beta_rate - beta_rate.detach() \
            + final_beta * rate.detach()

        loss = labda * distortion + beta_rate
        logs = {
            "loose_loss": loose_loss / LOG2,
            "loss": loss / LOG2,
            "rate": rate / LOG2,
            "distortion": distortion / LOG2,
            "ratedist": (rate + distortion) / LOG2,
            "beta": curr_beta,
        }
        return loss, logs

    def forward(self, x, targets, aux_target, *, training: bool = False,
                step: int = 0, generator=None, noise=None, eps=None):
        return self.step(x, targets, aux_target, training=training,
                         step=step, generator=generator, noise=noise,
                         eps=eps)


def _cat_draws(a, b):
    """The anchor's and the positive's draws as one 2B batch's (tensors,
    or tuples of them, such as the hyperprior's noise pair)."""
    if a is None or b is None:
        if a is not None or b is not None:
            raise ValueError("pass both views' draws or neither")
        return None
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b])
    return tuple(_cat_draws(u, v) for u, v in zip(a, b, strict=True))


def compressor_params_from_flax(tree, batch_stats=None) -> dict:
    """JAX `LearnableCompressor` variables (numpy arrays) -> state dict.

    `tree` is the `params` collection; `batch_stats`, when given, is merged
    into it (flax's running `mean` / `var` are the BatchNorm buffers). The
    encoder's mapper goes through `nn.vit.params_from_flax` when it is the
    CLIP tower, else (the MLP family, the ResNet, the CNN, BALLE with its
    GDN `beta_sqrt` / `gamma_sqrt`) through `nn.layers.params_from_flax`
    (the path joined with dots, conv kernels in their modules' layouts),
    as every other subtree does: the rate estimator (`affine`,
    `entropy_bottleneck`, the hyperprior's MLPs; `inner.*` of the spatial
    hyperprior), the distortion estimator (the direct decoder `q_YlZ`,
    MLP, CNN or BALLE; the contrastive `projector` and `logit_scale`) and
    the online probe. Values come back as fp32 tensors.
    """
    tree = _merge_stats(tree, batch_stats or {})
    mapper = tree["p_ZlX"]["mapper"]
    if "class_embedding" in mapper:   # the CLIP tower
        out = {f"p_ZlX.mapper.{k}": v
               for k, v in params_from_flax(mapper).items()}
    else:
        out = tree_params_from_flax(mapper, "p_ZlX.mapper.")
    for name in ("rate_estimator", "distortion_estimator",
                 "online_evaluator"):
        if name in tree:
            out.update(tree_params_from_flax(tree[name], f"{name}."))
    return out
