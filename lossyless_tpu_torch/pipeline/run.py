"""The featurizer stage's training loop.

Counterpart of the non-fused branch of `lossyless_tpu/pipeline/run.py`
(`run_featurizer`): resolve the precision, build the compressor and its
train state, bind the schedules to the planned steps, then one
`train_step` per batch, logging every `trainer.log_every` steps. The noise
of step i comes from a `torch.Generator` on the device seeded with i, as
the JAX loop keys step i with `jax.random.key(i)`.

The batches are an explicit iterable of `(x, y, aux)`: the COCO data
module waits for its files to be in the repository. Checkpoints,
validation and loggers wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable, Iterable

import torch

from ..compressors.compressor import LearnableCompressor
from ..core.device import resolve_device
from ..train.state import TrainState, bind_schedule_steps, train_step
from .config import ExperimentConfig, apply_precision


def _to(t, device):
    return t.to(device, non_blocking=True) if isinstance(t, torch.Tensor) \
        else t


def build_state(cfg: ExperimentConfig, total_steps: int,
                steps_per_epoch: int = 0, device=None) -> TrainState:
    """The compressor of `cfg` (seeded with `trainer.seed`) on `device`
    and its train state, with the schedules bound to `total_steps`."""
    device = resolve_device(device)
    model = LearnableCompressor(
        cfg.compressor_config(), frozen=tuple(cfg.frozen),
        generator=torch.Generator().manual_seed(cfg.trainer.seed))
    model.to(device)
    opts = [bind_schedule_steps(o, total_steps, steps_per_epoch)
            for o in (cfg.optimizer_feat, cfg.optimizer_online,
                      cfg.optimizer_coder)]
    return TrainState.create(model, main=opts[0], online=opts[1],
                             coder=opts[2], frozen_paths=tuple(cfg.frozen))


def run_featurizer(cfg: ExperimentConfig, batches: Iterable,
                   total_steps: int | None = None, device=None,
                   state: TrainState | None = None,
                   on_step: Callable | None = None,
                   log: Callable = print) -> TrainState:
    """Train the compressor of `cfg` on `batches` of (x, y, aux).

    `total_steps` (default `len(batches)`) is the planned span the
    schedules bind to. `state` continues an existing train state instead
    of building one. `on_step(step, state, logs)` runs after every
    update. Returns the train state.
    """
    cfg = apply_precision(copy.deepcopy(cfg))
    device = resolve_device(device)
    if total_steps is None:
        total_steps = len(batches)
    it = iter(batches)
    first = next(it, None)
    if first is None:
        raise ValueError("no batches to train on")
    if cfg.in_shape is None:
        cfg.in_shape = tuple(first[0].shape[1:])
    if state is None:
        spe = max(1, total_steps // max(1, cfg.data_feat.n_epochs))
        state = build_state(cfg, total_steps, spe, device)

    log_every = cfg.trainer.log_every
    for batch in itertools.chain([first], it):
        step = state.step
        batch = tuple(_to(t, device) for t in batch)
        generator = torch.Generator(device).manual_seed(step)
        state, logs = train_step(state, batch, generator)
        if on_step is not None:
            on_step(step, state, logs)
        if log_every and (step + 1) % log_every == 0:
            log(f"step {step + 1}: " + " ".join(
                f"{k}={float(v):.6g}" for k, v in sorted(logs.items())))
    return state
