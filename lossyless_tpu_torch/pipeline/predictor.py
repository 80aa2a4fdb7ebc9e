"""Downstream predictor stage: a probe trained on the frozen featurizer.

Counterpart of `lossyless_tpu/pipeline/predictor.py`:

* `featurize_dataset` runs the frozen compressor over a dataset once
  (`pad_to` pads a ragged last batch and trims its features) and returns
  (Z, Y) arrays;
* `Predictor` is the probe (`nn.registry`: linear, mlp, identity);
* `PredictorTrainer.fit` trains it on (Z, Y) on the device as JAX's does:
  one host permutation an epoch (`default_rng(seed)`), `n // bsz` full
  batches, Adam at `cfg.lr` (optax.adam's defaults); `fit_onfly` runs the
  featurizer inside the step on fresh batches each epoch; `evaluate`
  gives loss, accuracy, the per-task aggregates, the probe's inference
  time a sample and, with a weight table, the balanced metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from ..compressors.distortions import prediction_loss
from ..core.device import resolve_device
from ..nn.registry import get_architecture


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    arch: str = "mlp"
    arch_kwargs: dict = dataclasses.field(
        default_factory=lambda: dict(hid_dim=2048, n_hid_layers=2,
                                     norm_layer="batchnorm"))
    is_classification: bool = True
    lr: float = 3e-4
    n_epochs: int = 20
    batch_size: int = 256
    # run the frozen featurizer inside the probe's train step on fresh
    # batches every epoch; the default pre-featurizes the dataset once
    is_on_the_fly: bool = False


class Predictor(nn.Module):
    def __init__(self, cfg: PredictorConfig, in_shape, target_shape,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.predictor = get_architecture(cfg.arch, in_shape, target_shape,
                                          generator=generator,
                                          **cfg.arch_kwargs)

    def forward(self, features, *, training: bool = False):
        return self.predictor(features, training=training)


def featurize_dataset(featurize_fn, batches,
                      pad_to: int | None = None) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Run `featurize_fn` over (x, y, aux) batches -> (Z, Y) numpy arrays.
    `pad_to` pads a ragged batch up to that size by repeating its last row
    (one batch shape for every call) and drops the padded features."""
    zs, ys = [], []
    for x, y, _ in batches:
        x = torch.as_tensor(x)
        n = len(x)
        if pad_to is not None and n < pad_to:
            x = torch.cat([x, x[-1:].expand(pad_to - n, *x.shape[1:])])
        zs.append(torch.as_tensor(featurize_fn(x))[:n].float().cpu()
                  .numpy())
        ys.append(np.asarray(torch.as_tensor(y).cpu()))
    return np.concatenate(zs), np.concatenate(ys)


@dataclasses.dataclass
class PredictorTrainer:
    """Fit and evaluate the probe on `device` (the card unless given)."""

    cfg: PredictorConfig
    in_shape: Any
    target_shape: int
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _build(self, seed: int) -> Predictor:
        return Predictor(self.cfg, self.in_shape, self.target_shape,
                         torch.Generator().manual_seed(seed)).to(self.device)

    def _update(self, model, opt, xb, yb):
        opt.zero_grad(set_to_none=True)
        prediction_loss(model(xb, training=True), yb,
                        self.cfg.is_classification).mean().backward()
        opt.step()

    def _adam(self, model):
        # optax.adam's defaults, no decay
        return torch.optim.Adam(model.parameters(), lr=self.cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def fit(self, z_train, y_train, seed: int = 0):
        """Fit the probe on featurized arrays, which stay on the device."""
        model = self._build(seed)
        opt = self._adam(model)
        n = len(z_train)
        host_rng = np.random.default_rng(seed)
        bsz = min(self.cfg.batch_size, n)
        steps = max(1, n // bsz)
        z_dev = torch.as_tensor(np.asarray(z_train, np.float32),
                                device=self.device)
        y_dev = torch.as_tensor(np.asarray(y_train), device=self.device)
        for _ in range(self.cfg.n_epochs):
            order = torch.as_tensor(host_rng.permutation(n)[:steps * bsz],
                                    device=self.device).view(steps, bsz)
            for idx in order:
                self._update(model, opt, z_dev[idx], y_dev[idx])
        self.model = model
        return self

    def fit_onfly(self, dataset, featurize_fn, seed: int = 0):
        """Train with the frozen featurizer run on every batch of every
        epoch (fresh batches each epoch); ragged last batches are
        skipped."""
        bsz = min(self.cfg.batch_size, len(dataset))
        model = self._build(seed)
        opt = self._adam(model)
        for epoch in range(self.cfg.n_epochs):
            for xb, yb, _ in dataset.batches(bsz, n_epochs=1,
                                             seed=seed + epoch):
                if len(xb) != bsz:
                    continue
                with torch.no_grad():
                    zb = featurize_fn(xb).float()
                self._update(model, opt, zb,
                             torch.as_tensor(yb).to(self.device))
        self.model = model
        return self

    @torch.no_grad()
    def predict(self, z) -> np.ndarray:
        z = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
        return self.model(z, training=False).float().cpu().numpy()

    def evaluate(self, z, y, balancing_weights: dict | None = None) -> dict:
        """Loss/acc/err, the per-task aggregates, the inference time a
        sample and the balanced variants."""
        self.predict(z)  # first-call set-up outside the timing
        t0 = time.perf_counter()
        y_hat = self.predict(z)
        inference_time = (time.perf_counter() - t0) / max(1, len(z))

        y = np.asarray(y)
        th, ty = torch.from_numpy(y_hat), torch.from_numpy(y)
        cls = self.cfg.is_classification
        loss = prediction_loss(th, ty, cls).numpy()
        logs = {"loss": float(loss.mean()),
                "inference_time": inference_time}
        for agg in ("max", "std", "min", "mean", "median"):
            a = prediction_loss(th, ty, cls, agg_over_tasks=agg)
            logs[f"tasks_{agg}"] = float(a.numpy().mean())
        if cls:
            pred = y_hat.argmax(-1)
            acc = float((pred == y).mean())
            logs.update(acc=acc, err=1 - acc)
        if balancing_weights:
            w = np.asarray([balancing_weights.get(str(int(yi)), 1.0)
                            for yi in y])
            logs["balanced_loss"] = float((loss * w).mean())
            if cls:
                logs["balanced_acc"] = float(((pred == y) * w).mean())
                logs["balanced_err"] = 1 - logs["balanced_acc"]
        return logs
