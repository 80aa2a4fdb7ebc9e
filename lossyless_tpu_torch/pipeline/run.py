"""The featurizer stage's training loop and the communication stage.

Counterpart of `lossyless_tpu/pipeline/run.py`:

* `run_featurizer`, the non-fused branch: resolve the precision, build the
  compressor and its train state, bind the schedules to the planned steps,
  then one `train_step` per batch, logging every `trainer.log_every`
  steps through the `trainer.logger` (`train/feat/...` rows under the
  stage directory). The noise of step i comes from a `torch.Generator` on
  the device seeded with i, as the JAX loop keys step i with
  `jax.random.key(i)`.
* `run_communication`: real entropy coding of a measurement set with the
  trained rate (`H_factorized` or `H_hyper`): encode on the device, the
  coder's host compress and decompress, then `n_bits` and the per-image
  times, written to `results_communication.csv` with the stage sentinel.

The batches are an explicit iterable of `(x, y, aux)`: the COCO data
module waits for its files to be in the repository. Checkpoints and
validation wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import copy
import itertools
import time
from typing import Callable, Iterable

import torch

from ..compressors.compressor import LearnableCompressor
from ..compressors.rates import FactorizedCoder, HyperpriorCoder
from ..core.device import resolve_device
from ..train.checkpoints import mark_stage_done
from ..train.loggers import get_logger
from ..train.metrics import namespaced, write_results_csv
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
    update; every `trainer.log_every` steps the logs go to the logger and
    a line to `log`. Returns the train state.
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

    logger = get_logger(cfg.trainer.logger, cfg.stage_dir,
                        experiment=cfg.experiment, name="train_featurizer")
    log_every = cfg.trainer.log_every
    for batch in itertools.chain([first], it):
        step = state.step
        batch = tuple(_to(t, device) for t in batch)
        generator = torch.Generator(device).manual_seed(step)
        state, logs = train_step(state, batch, generator)
        if on_step is not None:
            on_step(step, state, logs)
        if log_every and (step + 1) % log_every == 0:
            logger.log(step + 1, namespaced(logs, "train", "feat"))
            log(f"step {step + 1}: " + " ".join(
                f"{k}={float(v):.6g}" for k, v in sorted(logs.items())))
    logger.finish()
    return state


@torch.no_grad()
def run_communication(cfg: ExperimentConfig, state: TrainState,
                      batches: Iterable, device=None) -> dict:
    """Real entropy coding of `batches` of (x, y, aux) with the trained
    rate: the encoder on `device`, then the coder's compress and
    decompress on the host. Returns the `test/comm/...` metrics (the
    reference's names: bits and seconds per image, sender = encoder +
    compress) and writes them, with the `communication` sentinel, under
    the stage directory."""
    device = resolve_device(device)
    model = state.model
    if cfg.rate.mode == "H_factorized":
        coder = FactorizedCoder.from_module(model.rate_estimator)
    elif cfg.rate.mode == "H_hyper":
        coder = HyperpriorCoder(model.rate_estimator)
    else:
        raise NotImplementedError(
            f"communication for rate mode {cfg.rate.mode!r} is not ported "
            f"yet (ROADMAP queue 1 items 5 and 10)")
    n, total_bytes = 0, 0
    t_enc = t_comp = t_dec = 0.0
    warmed = False
    for x, *_ in batches:
        x = _to(torch.as_tensor(x), device)
        if not warmed:  # first-call set-up outside the timing
            model.encode(x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            warmed = True
        t0 = time.perf_counter()
        z = model.encode(x).float().cpu().numpy()   # waits for the device
        t_enc += time.perf_counter() - t0
        t0 = time.perf_counter()
        streams = coder.compress(z)
        t_comp += time.perf_counter() - t0
        t0 = time.perf_counter()
        coder.decompress(streams)
        t_dec += time.perf_counter() - t0
        groups = streams if cfg.rate.mode == "H_hyper" else [streams]
        total_bytes += sum(len(s) for grp in groups for s in grp)
        n += len(z)
    if n == 0:
        raise ValueError("no batches to code")
    metrics = {"n_bits": 8 * total_bytes / n,
               "encoder_time": t_enc / n,
               "compress_time": t_comp / n,
               "receiver_time": t_dec / n,
               "sender_time": (t_enc + t_comp) / n}
    if isinstance(cfg.in_shape, (tuple, list)) and len(cfg.in_shape) == 3:
        h, w, _ = cfg.in_shape  # bits per pixel
        metrics["bpp"] = metrics["n_bits"] / (h * w)
    metrics = namespaced(metrics, "test", "comm")
    write_results_csv(cfg.stage_dir, "communication", metrics)
    mark_stage_done(cfg.stage_dir, "communication")
    return metrics
