"""Distortion estimators: the lossy-Z distortion of the hub compressor.

Counterpart of `lossyless_tpu/compressors/distortions.py`: all of
`DistortionConfig`, `prediction_loss`, `LossyZDistortion` (the p-norm of
`z_hat - p_zlx.mean`, for frozen pretrained encoders) and
`make_distortion_estimator`. The direct and contrastive distortions are not
ported yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


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


class LossyZDistortion(nn.Module):
    """Lp distance between z_hat and the encoder mean."""

    def __init__(self, cfg: DistortionConfig = DistortionConfig(
            mode="lossy_Z")):
        super().__init__()
        self.cfg = cfg

    def forward(self, z_hat, aux_target, p_zlx=None, *,
                training: bool = False):
        p = self.cfg.p_norm
        dist = torch.sum(torch.abs(z_hat - p_zlx.mean) ** p, dim=-1) \
            ** (1.0 / p)
        return dist, {}


def make_distortion_estimator(cfg: DistortionConfig, z_dim: int, y_shape):
    if cfg.mode == "lossy_Z":
        return LossyZDistortion(cfg)
    if cfg.mode in ("direct", "contrastive"):
        raise NotImplementedError(
            f"distortion mode {cfg.mode!r} is not ported yet (ROADMAP queue "
            f"1 item 6)")
    raise ValueError(f"unknown distortion mode={cfg.mode}")
