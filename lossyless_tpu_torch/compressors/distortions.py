"""Distortion estimators: direct reconstruction, contrastive, lossy Z.

Counterpart of `lossyless_tpu/compressors/distortions.py`:

* `DirectDistortion`: the variational bound -log q(Y|Z) through a decoder
  (`q_YlZ`: the registry's `cnn` in the `image` data mode, else `mlp`,
  unless `arch` names another); an image target is summed per example, a
  coloured one as the squared error of the sigmoid, a grayscale one as
  the Bernoulli negative log-likelihood of the logits (`_bce_with_logits`,
  JAX's form and its gradient at logit 0); the other modes take the
  prediction loss;
* `ContrastiveDistortion`: InfoNCE over the global batch of both views'
  representations, with the projector MLP, the learned temperature and
  the effective-batch-size reweighting;
* `LossyZDistortion`: the p-norm of `z_hat - p_zlx.mean`, for frozen
  pretrained encoders;
* `DistortionConfig`, `prediction_loss`, `make_distortion_estimator`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import mesh
from ..core.math import LOG2, abs_jax
from ..nn.mlp import MLP
from ..nn.registry import get_architecture


@dataclasses.dataclass(frozen=True)
class DistortionConfig:
    mode: str = "direct"                 # direct|contrastive|lossy_Z
    # direct:
    arch: str | None = None
    arch_kwargs: dict = dataclasses.field(default_factory=dict)
    data_mode: str = "image"             # image|distribution|feature
    is_classification: bool = True
    # contrastive:
    temperature: float = 0.01
    is_train_temperature: bool = True
    is_cosine: bool = True
    effective_batch_size: float | None = None
    is_already_featurized: bool = False
    is_project: bool = True
    project_dim: int = 128
    concat_views: bool = False
    # lossy_Z:
    p_norm: float = 1.0


def prediction_loss(y_hat, y, is_classification=True,
                    agg_over_tasks: str | None = "mean"):
    """Per-sample CE or MSE: predictions (batch, Y_dim[, n_tasks]); the loss
    is averaged over Y_dim, then aggregated over tasks with
    `agg_over_tasks` ({mean,sum,max,min,median,std} or None)."""
    if is_classification:
        y = y.long()
        if y_hat.dim() <= 2:
            logp = F.log_softmax(y_hat, dim=-1)
            per = -torch.gather(logp, -1, y[..., None])[..., 0]
        else:
            # the class axis is dim 1, trailing dims are tasks
            logp = F.log_softmax(y_hat, dim=1)
            per = -torch.gather(logp, 1, y[:, None, ...])[:, 0]
    else:
        per = (y_hat - y.to(y_hat.dtype)) ** 2
    b = y_hat.shape[0]
    if per.dim() <= 2:
        per = per.reshape(b, -1, 1)          # single task
    per_task = per.mean(dim=1)               # (batch, n_tasks)
    if agg_over_tasks is None:
        return per_task
    if agg_over_tasks == "median":
        # jnp.median averages the two middle values of an even count
        return per_task.quantile(0.5, dim=-1)
    if agg_over_tasks == "std":
        return per_task.std(dim=-1, unbiased=False)
    agg = {"mean": torch.mean, "sum": torch.sum,
           "max": lambda t, dim: t.amax(dim=dim),
           "min": lambda t, dim: t.amin(dim=dim)}
    return agg[agg_over_tasks](per_task, dim=-1)


class DirectDistortion(nn.Module):
    """Variational reconstruction bound -log q(Y|Z) through the decoder
    `q_YlZ`: per example, the image's summed negative log-likelihood, or
    the prediction loss of the other data modes."""

    def __init__(self, z_dim: int, y_shape, cfg: DistortionConfig =
                 DistortionConfig(), generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.is_img_out = cfg.data_mode == "image"
        arch = cfg.arch or ("cnn" if self.is_img_out else "mlp")
        self.q_YlZ = get_architecture(arch, z_dim, y_shape,
                                      generator=generator, **cfg.arch_kwargs)

    def forward(self, z_hat, aux_target, p_zlx=None, *,
                training: bool = False):
        y_hat = self.q_YlZ(z_hat, training=training)
        if self.is_img_out:
            if aux_target.shape[-1] == 3:
                # colour: a Gaussian on the sigmoid's [0, 1] output
                neg_log = (torch.sigmoid(y_hat) - aux_target) ** 2
            else:
                # grayscale: a Bernoulli of the logits
                neg_log = _bce_with_logits(y_hat, aux_target)
            neg_log = neg_log.reshape(z_hat.shape[0], -1).sum(-1)
        else:
            neg_log = prediction_loss(y_hat, aux_target,
                                      self.cfg.is_classification)
        return neg_log, {"H_q_TlZ": neg_log.mean() / LOG2}

    def reconstruct(self, z_hat):
        """The decoder's output: [0, 1] images (the sigmoid) in the image
        mode."""
        y_hat = self.q_YlZ(z_hat, training=False)
        return torch.sigmoid(y_hat) if self.is_img_out else y_hat


def _bce_with_logits(logits, targets):
    """JAX's `_bce_with_logits`, term for term: `torch.maximum` splits its
    tie 1/2 : 1/2 as `jnp.maximum` does and `abs_jax` takes d|x| = 1 at
    0, so the gradient at logit 0 is 1/2 - target - 1/2 (JAX's), where
    `F.binary_cross_entropy_with_logits` gives the analytic 1/2 - target."""
    return torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * targets + torch.log1p(torch.exp(-abs_jax(logits)))


class ContrastiveDistortion(nn.Module):
    """InfoNCE (BINCE) distortion over the global batch.

    `z_hat` and `z_pos_hat` are the two views' representations (the
    compressor encodes the second view). The positive of row i is row
    i + B (mod 2B); every other row of both views is a negative. The
    temperature is 1 / min(exp(logit_scale), 1 / temperature), written
    with `torch.minimum` so that the bound splits the gradient in half as
    `jnp.clip` does; the self-similarity is masked with -inf after the
    division, so the mask never reaches the temperature's gradient.

    In a data-parallel step (`core.mesh.data_parallel`) the batch is the
    global one, as under JAX's pjit: each view's rows are gathered from
    every rank in rank order (`all_gather_rows`, the reference's
    `GatherFromGpus`), which rebuilds the one-device batch as the keys;
    the rank's own rows are the queries."""

    def __init__(self, z_dim: int, cfg: DistortionConfig = DistortionConfig(
            mode="contrastive"), generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        if cfg.is_project:
            self.projector = MLP(z_dim, cfg.project_dim,
                                 hid_dim=cfg.project_dim, n_hid_layers=1,
                                 generator=generator)
        if cfg.is_train_temperature:
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, z_hat, z_pos_hat, p_zlx=None, *,
                training: bool = False):
        c = self.cfg
        batch_size = z_hat.shape[0]
        zs = torch.cat([z_hat, z_pos_hat]).float()
        if c.is_project:
            zs = self.projector(zs, training=training)
        if c.is_cosine:
            # eps inside the square root: a zero row (a dead-ReLU
            # projector's output) gets a finite, zero gradient
            zs = zs / torch.sqrt((zs * zs).sum(-1, keepdim=True) + 1e-12)

        dp = mesh.active()
        if dp is None:
            keys = zs
            q_idx = torch.arange(2 * batch_size, device=zs.device)
        else:       # the global batch's rows as keys, this rank's as queries
            rank, world = dp[:2]
            keys = torch.cat([mesh.all_gather_rows(zs[:batch_size]),
                              mesh.all_gather_rows(zs[batch_size:])])
            mine = torch.arange(rank * batch_size, (rank + 1) * batch_size,
                                device=zs.device)
            q_idx = torch.cat([mine, mine + world * batch_size])
        n = keys.shape[0]
        logits = zs @ keys.T
        pos_idx = (q_idx + n // 2) % n
        n_classes = n - 1
        if c.effective_batch_size is not None:
            effective_n_classes = 2 * c.effective_batch_size - 1
            to_mult = (effective_n_classes - 1) / (n_classes - 1)
            # log(to_mult) added to the negatives == taken off the positive
            logits = logits - math.log(to_mult) * F.one_hot(pos_idx, n).float()
        else:
            effective_n_classes = n_classes

        if c.is_train_temperature:
            bound = torch.full_like(self.logit_scale, 1.0 / c.temperature)
            temperature = 1.0 / torch.minimum(self.logit_scale.exp(), bound)
        else:
            temperature = c.temperature
        logits = logits / temperature
        self_mask = q_idx[:, None] == torch.arange(n, device=zs.device)
        logits = logits.masked_fill(self_mask, -math.inf)

        logp = F.log_softmax(logits, dim=-1)
        hat_H_mlz = -logp.gather(-1, pos_idx[:, None])[:, 0]
        hat_H_m = math.log(effective_n_classes)
        logs = {"I_q_zm": (hat_H_m - hat_H_mlz.mean()) / LOG2,
                "hat_H_m": hat_H_m / LOG2,
                "n_negatives": float(n_classes)}
        # the two views' losses averaged a sample
        return (hat_H_mlz[:batch_size] + hat_H_mlz[batch_size:]) / 2, logs


class LossyZDistortion(nn.Module):
    """Lp distance between z_hat and the encoder mean."""

    def __init__(self, cfg: DistortionConfig = DistortionConfig(
            mode="lossy_Z")):
        super().__init__()
        self.cfg = cfg

    def forward(self, z_hat, aux_target, p_zlx=None, *,
                training: bool = False):
        p = self.cfg.p_norm
        dist = torch.sum(abs_jax(z_hat - p_zlx.mean) ** p, dim=-1) \
            ** (1.0 / p)
        return dist, {}


def make_distortion_estimator(cfg: DistortionConfig, z_dim: int, y_shape,
                              generator: torch.Generator | None = None):
    """`generator` seeds the decoder's or the projector's init."""
    if cfg.mode == "direct":
        return DirectDistortion(z_dim, y_shape, cfg, generator)
    if cfg.mode == "contrastive":
        return ContrastiveDistortion(z_dim, cfg, generator)
    if cfg.mode == "lossy_Z":
        return LossyZDistortion(cfg)
    raise ValueError(f"unknown distortion mode={cfg.mode}")
