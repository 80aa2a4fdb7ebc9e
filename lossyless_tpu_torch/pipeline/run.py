"""The three-stage pipeline: featurizer -> communication -> predictor.

Counterpart of `lossyless_tpu/pipeline/run.py`:

* `run_featurizer(cfg, batches)`: the training loop over an explicit
  iterable of `(x, y, aux)` batches: one `train_step` a batch, logging
  every `trainer.log_every` steps through the `trainer.logger`
  (`train/feat/...` rows under the stage directory). The noise of step i
  comes from a `torch.Generator` on the device seeded with i, as the JAX
  loop keys step i with `jax.random.key(i)`.
* `run_featurizer_stage(cfg)`: JAX's `run_featurizer(cfg)`, the
  datamodule-driven stage built on that loop: an epoch is one
  `run_featurizer` over the epoch's host batches or, when
  `trainer.use_fused_epochs` is set and the dataset has a
  `device_sampler` (the banana source, the image datasets), one
  `make_generative_epoch` of batches drawn (and augmented) on the device,
  its generators keyed by `trainer.seed + epoch`; the encoder's weights
  from `encoder.pretrained_path` when it names one; then validation, the `last` and `best` checkpoints
  (`CheckpointManager`; a run resumes from `last`), the plateau
  controllers, the best weights restored and exported
  (`best_featurizer`), and the test split's metrics with `encoder_time`
  in `results_featurizer.csv`.
* `run_communication`: real entropy coding of a measurement set with the
  trained rate (`H_factorized`, `H_hyper`, `H_spatial`), the gzip'd
  size of the raw features (`lossless`), or for `MI` the rate the
  estimator bounds (no coder: `is_real_coding` 0): `n_bits` and the
  per-image times, written to `results_communication.csv` with the stage
  sentinel.
* `run_predictor`: featurize the predictor's datasets through the frozen
  compressor, fit the probe (`pipeline/predictor.py`), evaluate it on the
  test split: `results_predictor.csv`; on Galaxy Zoo also the kaggle
  submission of its predictions (`analysis/kaggle.py`).
* `main(cfg)`: the three stages, each skipped when its sentinel exists; a
  finished featurizer is rebuilt from its exported weights.

Data parallelism (JAX's `trainer.n_devices`, `_training_mesh`): `main`
with `trainer.n_devices=N > 1` spawns N ranks (one a card, or N gloo
processes on the CPU) unless it already runs in a process group of N
ranks (torchrun, `core.mesh.init_distributed`). Each rank builds the same
seeded state, draws the same global batches and trains on its rows inside
`core.mesh.data_parallel` (global draws, BatchNorm statistics, contrastive
gather, averaged gradients and logs), so N ranks reproduce one device's
run to roundoff; batch sizes round to a multiple of N (`_fit_bsz`). Rank 0
alone validates (the monitored value is broadcast), writes the
checkpoints, logs and export, and runs the test evaluation, the
communication stage and the predictor; the other ranks return after the
featurizer stage's training. Every rank reads a resume checkpoint.

Every entry point runs on the card unless `device` says otherwise; the
external datasets (`data/external.py`) decode their JPEGs on the host and
augment the batches on that device.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from ..analysis.kaggle import write_kaggle_submission
from ..compressors.compressor import LearnableCompressor
from ..compressors.rates import (FactorizedCoder, HyperpriorCoder,
                                 SpatialHyperpriorCoder, lossless_bits)
from ..core import mesh
from ..core.device import resolve_device
from ..data.balancing import get_balancing_weights
from ..data.banana import BananaDataset
from ..data.external import EXTERNAL_DATASETS
from ..data.images import get_datamodule
from ..nn.pretrained import load_pretrained_encoder
from ..train.checkpoints import (CheckpointManager, is_stage_done,
                                 load_weights, mark_stage_done,
                                 resolve_swap, save_weights)
from ..train.loggers import get_logger
from ..train.metrics import MetricAccumulator, namespaced, write_results_csv
from ..train.state import (ReduceLROnPlateau, TrainState,
                           bind_schedule_steps, eval_step, get_plateau_scale,
                           make_generative_epoch, set_plateau_scale,
                           train_step)
from .config import ExperimentConfig, apply_precision
from .predictor import PredictorTrainer, featurize_dataset


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
                   log: Callable = print, logger=None) -> TrainState:
    """Train the compressor of `cfg` on `batches` of (x, y, aux).

    `total_steps` (default `len(batches)`) is the planned span the
    schedules bind to. `state` continues an existing train state instead
    of building one; a state built here takes the encoder's weights from
    `encoder.pretrained_path` when it names one. `on_step(step, state,
    logs)` runs after every update; every `trainer.log_every` steps the
    logs go to the logger (a new one for the stage directory unless
    `logger` is given; a given one is left open) and a line to `log`.
    Returns the train state.
    """
    cfg = apply_precision(copy.deepcopy(cfg))
    device = resolve_device(device)
    if state is None and total_steps is None:
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
        if cfg.encoder.pretrained_path:
            load_pretrained_encoder(cfg.encoder, state.model)

    own_logger = logger is None
    if own_logger:
        logger = _stage_logger(cfg)
    log_every = cfg.trainer.log_every
    rank, world = mesh.rank_world()
    if rank != 0:
        log = _quiet
    for batch in itertools.chain([first], it):
        step = state.step
        # this rank's rows of the global batch (all of it on one device)
        batch = mesh.shard_batch(tuple(batch), rank, world)
        batch = tuple(_to(t, device) for t in batch)
        generator = _step_generator(device, step)
        with mesh.data_parallel(rank, world, len(batch[0])):
            state, logs = train_step(state, batch, generator)
        if on_step is not None:
            on_step(step, state, logs)
        if log_every and (step + 1) % log_every == 0:
            logger.log(step + 1, namespaced(logs, "train", "feat"))
            log(f"step {step + 1}: " + " ".join(
                f"{k}={float(v):.6g}" for k, v in sorted(logs.items())))
    if own_logger:
        logger.finish()
    return state


def _stage_logger(cfg: ExperimentConfig):
    return get_logger(cfg.trainer.logger, cfg.stage_dir,
                      experiment=cfg.experiment, name="train_featurizer")


def _git_hash() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=Path(__file__).parent,
            timeout=5).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _quiet(*args):
    """The line log of a rank other than 0 (rank 0 prints the global
    batch's logs)."""


def _fit_bsz(requested: int, n: int, n_devices: int | None = None) -> int:
    """The batch size clamped to the dataset and, over `n_devices` ranks
    (default: the process group's), a multiple of them when the dataset
    has that many samples (JAX's `_fit_bsz`)."""
    if n_devices is None:
        n_devices = mesh.rank_world()[1]
    b = max(1, min(requested, n))
    if n_devices > 1 and n >= n_devices:
        b = max(n_devices, b - b % n_devices)
    return b


def _training_mesh(cfg: ExperimentConfig, device) -> int:
    """The number of ranks `trainer.n_devices` asks for (JAX's
    `_training_mesh`): 0 (or -1) means every visible device, more than are
    visible raises. Visible: the CUDA devices; on the CPU one device for 0,
    as JAX counts it, and up to its cores when asked for (a gloo rank a
    process); inside a process group its ranks, which the count must then
    equal."""
    n = cfg.trainer.n_devices
    world = mesh.rank_world()[1]
    every, avail = (world, world) if world > 1 else \
        mesh.visible_devices(device)
    if n in (0, -1, None):
        n = every
    if n > avail:
        raise ValueError(f"trainer.n_devices={n} but only {avail} devices "
                         f"are visible")
    if world > 1 and n != world:
        raise ValueError(f"trainer.n_devices={n} but the process group has "
                         f"{world} ranks")
    return n


def _batch_to(batch, device):
    return tuple(_to(torch.as_tensor(t), device) for t in batch)


def _step_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _datamodule(name: str, device, **kwargs):
    """`get_datamodule`, an external dataset's batches on `device` unless
    its kwargs name one."""
    if name in EXTERNAL_DATASETS:
        kwargs.setdefault("device", device)
    return get_datamodule(name, **kwargs)


def instantiate_datamodule(cfg: ExperimentConfig, data_cfg, split="train",
                           device=None):
    """Build the dataset and write its shapes into `cfg`; an external
    dataset's batches lie on `device` (default: the card)."""
    kwargs = dict(data_cfg.kwargs)
    if data_cfg.name == "banana":
        ds = BananaDataset(**kwargs)
        cfg.in_shape = (2,)
        cfg.target_shape = 1
        at = kwargs.get("additional_target", "representative")
        cfg.aux_shape = 1 if at == "target" else 2
        return ds
    ds = _datamodule(data_cfg.name, device, split=split, **kwargs)
    cfg.in_shape = ds.spec.shape
    cfg.target_shape = ds.spec.n_classes
    if hasattr(ds, "aux_shape"):      # the external datasets say theirs
        cfg.aux_shape = ds.aux_shape
    else:
        at = kwargs.get("additional_target",
                        getattr(ds, "additional_target", "representative"))
        cfg.aux_shape = (ds.spec.shape if at in
                         ("input", "representative", "equiv_x")
                         else ds.spec.n_classes)
    return ds


def _eval_dataset(cfg: ExperimentConfig, data_cfg, split: str, device=None):
    """An evaluation split ("validation" for model selection, "test" for
    the final metrics), in the evaluation view (no augmentation). The
    banana source's splits are fresh samples: at most 20,480 of them, seeded
    `trainer.seed` + 1 (validation) or + 2 (test)."""
    kwargs = dict(data_cfg.kwargs)
    if data_cfg.name == "banana":
        kwargs["length"] = min(kwargs.get("length", 20480), 20480)
        kwargs["seed"] = cfg.trainer.seed + (1 if split == "validation"
                                             else 2)
        return BananaDataset(**kwargs)
    kwargs.setdefault("is_augment", False)
    return _datamodule(data_cfg.name, device, split=split, **kwargs)


def _val_dataset(cfg: ExperimentConfig, data_cfg, device=None):
    return _eval_dataset(cfg, data_cfg, "validation", device)


def _test_dataset(cfg: ExperimentConfig, data_cfg, device=None):
    return _eval_dataset(cfg, data_cfg, "test", device)


def _all_batches(ds, bsz: int, seed: int):
    """All samples: full batches and the ragged tail (a generative source
    has no tail to keep)."""
    if isinstance(ds, BananaDataset):
        return ds.batches(bsz, n_epochs=1, seed=seed)
    return ds.batches(bsz, n_epochs=1, seed=seed, drop_last=False)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _evaluate(state: TrainState, dataset, cfg: ExperimentConfig, stage: str,
              batch_size: int, device) -> dict:
    """The eval-step metrics over the whole split (ragged tail kept) and
    `encoder_time`, the encoder's seconds an image, timed on the same
    batches; each batch size's first encode runs untimed first."""
    acc = MetricAccumulator()
    batch_size = _fit_bsz(batch_size, len(dataset))
    n_total = max(1, math.ceil(len(dataset) / batch_size))
    n_keep = max(1, int(n_total * cfg.trainer.limit_eval_batches))
    sizes: set[int] = set()
    t_enc, n_timed = 0.0, 0
    for i, b in enumerate(itertools.islice(
            _all_batches(dataset, batch_size, cfg.trainer.seed), n_keep)):
        b = _batch_to(b, device)
        _, logs = eval_step(state, b, _step_generator(device, 1000 + i))
        acc.update(logs, weight=len(b[0]))
        x = b[0]
        if len(x) not in sizes:  # first-call set-up at this shape, untimed
            sizes.add(len(x))
            state.model.encode(torch.zeros_like(x))
        _sync(device)
        t0 = time.perf_counter()
        state.model.encode(x)
        _sync(device)
        t_enc += time.perf_counter() - t0
        n_timed += len(x)
    metrics = acc.means()
    metrics["encoder_time"] = t_enc / max(1, n_timed)
    return namespaced(metrics, "test", stage)


def _plateau_controllers(cfg: ExperimentConfig, state: TrainState) -> dict:
    """One host controller a plateau group, all on the checkpoint's
    monitor, each seeded with the group's (restored) scale."""
    ctls = {}
    for label, o in (("main", cfg.optimizer_feat),
                     ("online", cfg.optimizer_online),
                     ("coder", cfg.optimizer_coder)):
        scale = get_plateau_scale(state, label)
        if o.scheduler == "plateau" and scale is not None:
            ctl = ReduceLROnPlateau(
                factor=o.plateau_factor, patience=o.plateau_patience,
                threshold=o.plateau_threshold,
                min_scale=o.plateau_min_lr / max(o.lr, 1e-30),
                mode=cfg.trainer.monitor_mode)
            ctl.scale = scale
            ctls[label] = ctl
    return ctls


def run_featurizer_stage(cfg: ExperimentConfig, device=None,
                         on_step: Callable | None = None,
                         log: Callable = print):
    """The featurizer stage on `cfg.data_feat` (JAX's `run_featurizer(cfg)`).

    Writes the datasets' shapes into `cfg`. Resumes from the `last`
    checkpoint when there is one. Returns (state, train_ds, test_ds,
    metrics); in a process group of more than one rank, the ranks other
    than 0 return after training with (state, train_ds, None, {}).
    """
    device = resolve_device(device)
    stage_dir = cfg.stage_dir
    rank, world = mesh.rank_world()
    train_ds = instantiate_datamodule(cfg, cfg.data_feat, device=device)
    if len(train_ds) < world:
        raise ValueError(
            f"trainer.n_devices={world} but the training set has only "
            f"{len(train_ds)} samples: cannot shard one batch over them")
    bsz = _fit_bsz(cfg.data_feat.batch_size, len(train_ds), world)
    rows = bsz // world       # a rank's rows of each global batch
    steps_per_epoch = max(1, int((len(train_ds) // bsz)
                                 * cfg.trainer.limit_train_batches))
    if cfg.rate.warmup_k_epochs > 0 and cfg.rate.warmup_steps == 0:
        # the epoch-denominated rate warmup, now that an epoch is known
        cfg.rate = dataclasses.replace(
            cfg.rate,
            warmup_steps=cfg.rate.warmup_k_epochs * steps_per_epoch)
    n_epochs = cfg.data_feat.n_epochs
    state = build_state(cfg, steps_per_epoch * n_epochs, steps_per_epoch,
                        device)
    if cfg.encoder.pretrained_path:
        # a resumed checkpoint below holds these weights already
        load_pretrained_encoder(cfg.encoder, state.model)
    ckpt = CheckpointManager(Path(cfg.ckpt_dir) / cfg.long_name / "feat",
                             monitor=cfg.trainer.monitor,
                             mode=cfg.trainer.monitor_mode)
    if ckpt.has_last:
        ckpt.restore(state, "last")
    logger = _stage_logger(cfg)
    val_ds = _val_dataset(cfg, cfg.data_feat, device) if rank == 0 else None
    plateau = _plateau_controllers(cfg, state)
    # `trainer.monitor="train_<metric>"` monitors the epoch-mean train
    # metric instead of a validation metric
    monitor_train_key = (cfg.trainer.monitor[len("train_"):]
                         if cfg.trainer.monitor.startswith("train_")
                         else None)

    # the fused path: batches drawn on the device, one readback an epoch
    epoch_fn = None
    if cfg.trainer.use_fused_epochs and hasattr(train_ds, "device_sampler"):
        # a rank's sampler draws its rows of each global batch
        epoch_fn = make_generative_epoch(train_ds.device_sampler(rows),
                                         steps_per_epoch, rank, world, rows)

    for epoch in range(state.step // steps_per_epoch, n_epochs):
        train_vals = []

        def step_hook(step, st, logs):
            if monitor_train_key is not None and monitor_train_key in logs:
                train_vals.append(logs[monitor_train_key])
            if on_step is not None:
                on_step(step, st, logs)

        if epoch_fn is not None:
            _fused_epoch(cfg, epoch_fn, state, epoch, steps_per_epoch,
                         step_hook, logger)
        else:
            epoch_batches = itertools.islice(
                train_ds.batches(bsz, n_epochs=1,
                                 seed=cfg.trainer.seed + epoch),
                steps_per_epoch)
            run_featurizer(cfg, epoch_batches, device=device, state=state,
                           on_step=step_hook, log=log, logger=logger)

        # epoch-end validation (rank 0) and checkpoints (rank 0 writes)
        val = _validate(cfg, state, val_ds, device) if rank == 0 else {}
        logger.log(state.step, namespaced(val, "val", "feat"))
        if (epoch + 1) % cfg.trainer.ckpt_every_epochs == 0:
            ckpt.save_last(state, state.step)
        # a diverged epoch's metrics are dropped by the accumulator, so a
        # missing monitor is NaN (never best), not 0.0
        if monitor_train_key is not None:
            monitor_val = float(torch.stack(
                [torch.as_tensor(v, dtype=torch.float32).cpu()
                 for v in train_vals]).mean()) if train_vals else math.nan
        else:
            monitor_val = val.get(cfg.trainer.monitor,
                                  val.get("loss", math.nan))
        if world > 1:   # every rank's plateau controllers step on rank 0's
            box = [monitor_val]
            torch.distributed.broadcast_object_list(box, src=0)
            monitor_val = box[0]
        ckpt.maybe_save_best(state, state.step, monitor_val)
        for label, ctl in plateau.items():
            set_plateau_scale(state, ctl.step(float(monitor_val)), label)

    if rank != 0:
        logger.finish()
        return state, train_ds, None, {}

    # the best weights, exported weights-only for the next stages
    ckpt.restore(state, "best")
    save_weights(Path(cfg.ckpt_dir) / cfg.long_name / "best_featurizer",
                 state.model.state_dict())
    logger.finish()

    # final metrics on the test split, touched once: model selection above
    # used the validation split only
    test_ds = _test_dataset(cfg, cfg.data_feat, device)
    metrics = _evaluate(state, test_ds, cfg, "feat",
                        cfg.data_feat.val_batch_size, device)
    metrics["n_param"] = int(sum(p.numel()
                                 for p in state.model.parameters()))
    metrics["git_hash"] = _git_hash()
    write_results_csv(stage_dir, "featurizer", metrics)
    mark_stage_done(stage_dir, "featurizer")
    return state, train_ds, test_ds, metrics


def _validate(cfg: ExperimentConfig, state: TrainState, val_ds,
              device) -> dict:
    """The eval-step metrics over the validation split's full batches."""
    acc = MetricAccumulator()
    vbs = _fit_bsz(cfg.data_feat.val_batch_size, len(val_ds))
    n_vb = max(1, len(val_ds) // vbs)  # ragged validation tails dropped
    n_vkeep = max(1, int(n_vb * cfg.trainer.limit_eval_batches))
    for j, b in enumerate(itertools.islice(
            val_ds.batches(vbs, n_epochs=1, seed=cfg.trainer.seed),
            n_vkeep)):
        b = _batch_to(b, device)
        _, vlogs = eval_step(state, b, _step_generator(device, 2000 + j))
        acc.update(vlogs, weight=len(b[0]))
    return acc.means()


def _fused_epoch(cfg: ExperimentConfig, epoch_fn, state: TrainState,
                 epoch: int, steps_per_epoch: int, step_hook: Callable,
                 logger):
    """One epoch of `make_generative_epoch`, keyed by `trainer.seed +
    epoch`. The logs come back stacked: `step_hook` sees each step's row
    afterwards (with the epoch's final state), and the logger one row of
    window means every `trainer.log_every` steps, as JAX logs its fused
    epochs."""
    first = state.step
    _, logs = epoch_fn(state, cfg.trainer.seed + epoch)
    for i in range(steps_per_epoch):
        step_hook(first + i, state, {k: v[i] for k, v in logs.items()})
    if cfg.trainer.log_every:
        le = max(1, int(cfg.trainer.log_every))
        for s in range(0, steps_per_epoch, le):
            chunk = {k: float(np.mean(v[s:s + le])) for k, v in logs.items()}
            logger.log(first + min(s + le, steps_per_epoch),
                       namespaced(chunk, "train", "feat"))


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
    if cfg.rate.mode == "lossless":
        zs = [model.encode(_to(torch.as_tensor(x), device)).float().cpu()
              .numpy() for x, *_ in batches]
        if not zs:
            raise ValueError("no batches to code")
        return _finish_communication(
            cfg, {"n_bits": lossless_bits(np.concatenate(zs))})
    if cfg.rate.mode == "MI":
        # no coder: the rate the estimator bounds, from rate-only steps
        acc = MetricAccumulator()
        for i, b in enumerate(batches):
            b = _batch_to(b, device)
            _, logs = eval_step(state, b, _step_generator(device, 3000 + i),
                                is_rate_only=True)
            acc.update(logs, weight=len(b[0]))
        return _finish_communication(cfg, {
            "rate": acc.means().get("rate", math.nan),
            "is_real_coding": 0.0})
    if cfg.rate.mode == "H_factorized":
        coder = FactorizedCoder.from_module(model.rate_estimator)
    elif cfg.rate.mode == "H_hyper":
        coder = HyperpriorCoder(model.rate_estimator)
    elif cfg.rate.mode == "H_spatial":
        coder = SpatialHyperpriorCoder(model.rate_estimator)
    else:
        raise ValueError(f"unknown rate mode={cfg.rate.mode}")
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
        groups = streams if cfg.rate.mode in ("H_hyper", "H_spatial") \
            else [streams]
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
    return _finish_communication(cfg, metrics)


def _finish_communication(cfg: ExperimentConfig, metrics: dict) -> dict:
    metrics = namespaced(metrics, "test", "comm")
    write_results_csv(cfg.stage_dir, "communication", metrics)
    mark_stage_done(cfg.stage_dir, "communication")
    return metrics


def _predictor_datasets(cfg: ExperimentConfig, train_ds, val_ds,
                        device=None):
    """The predictor stage's (train, test) datasets and target shape: on
    `data_pred` when set (its shapes go into a scratch copy of `cfg`),
    else on `data_feat`. Pre-featurization freezes one view a sample, the
    evaluation view unless the probe runs on the fly."""
    if cfg.data_pred is None:
        if not cfg.predictor.is_on_the_fly and cfg.data_feat.name != \
                "banana":
            kwargs = dict(cfg.data_feat.kwargs)
            kwargs.setdefault("is_augment", False)
            pred_train = instantiate_datamodule(
                copy.copy(cfg),
                dataclasses.replace(cfg.data_feat, kwargs=kwargs),
                device=device)
            return pred_train, val_ds, cfg.target_shape
        return train_ds, val_ds, cfg.target_shape

    scratch = copy.copy(cfg)
    kwargs = dict(cfg.data_pred.kwargs)
    if cfg.data_pred.name != "banana":
        kwargs.setdefault("is_augment", cfg.predictor.is_on_the_fly)
    data_cfg = dataclasses.replace(cfg.data_pred, kwargs=kwargs)
    pred_train = instantiate_datamodule(scratch, data_cfg, device=device)
    pred_val = _test_dataset(scratch, data_cfg, device)
    if scratch.in_shape != cfg.in_shape:
        raise ValueError(
            f"data_pred={cfg.data_pred.name!r} has input shape "
            f"{scratch.in_shape} but the featurizer was trained on "
            f"{cfg.in_shape}; the frozen featurizer cannot consume it.")
    return pred_train, pred_val, scratch.target_shape


def run_predictor(cfg: ExperimentConfig, state: TrainState, train_ds,
                  val_ds, device=None) -> dict:
    """Fit the probe on the frozen compressor's features and evaluate it
    on the test split; writes `results_predictor.csv` and the sentinel.
    On Galaxy Zoo one unshuffled pass over the test split both evaluates
    and predicts, and the predictions go to `kaggle_submission.csv` in
    the stage directory under the split's GalaxyIDs (positional ids,
    flagged `synthetic_positional`, on synthetic data; no file,
    `skipped_no_ids`, where the split has no ids)."""
    device = resolve_device(device)
    model = state.model

    @torch.no_grad()
    def feat_fn(x):
        return model.features(_to(torch.as_tensor(x), device))

    data_cfg = cfg.data_pred or cfg.data_feat
    pred_train, pred_val, target_shape = _predictor_datasets(
        cfg, train_ds, val_ds, device)
    bsz = _fit_bsz(data_cfg.batch_size, len(pred_train))
    if cfg.predictor.is_on_the_fly:
        x0, _, _ = next(pred_train.batches(2, seed=cfg.trainer.seed))
        trainer = PredictorTrainer(cfg.predictor, feat_fn(x0).shape[-1],
                                   target_shape, device)
        trainer.fit_onfly(pred_train, feat_fn, seed=cfg.trainer.seed)
    else:
        z_tr, y_tr = featurize_dataset(
            feat_fn, _all_batches(pred_train, bsz, cfg.trainer.seed),
            pad_to=bsz)
        trainer = PredictorTrainer(cfg.predictor, z_tr.shape[-1],
                                   target_shape, device)
        trainer.fit(z_tr, y_tr, seed=cfg.trainer.seed)
    is_galaxy = data_cfg.name.startswith("galaxy")
    # Galaxy Zoo: the split in its own order (evaluate is order-blind,
    # the submission needs the order of the ids)
    test_batches = pred_val.batches(
        bsz, n_epochs=1, seed=0, shuffle=False, drop_last=False) \
        if is_galaxy else _all_batches(pred_val, bsz, cfg.trainer.seed)
    z_te, y_te = featurize_dataset(feat_fn, test_batches, pad_to=bsz)
    # the published per-class weights of the imbalanced datasets
    weights = get_balancing_weights(data_cfg.name)
    metrics = namespaced(trainer.evaluate(z_te, y_te,
                                          balancing_weights=weights),
                         "test", "pred")
    metrics["data_pred"] = data_cfg.name
    if is_galaxy:
        metrics.update(_kaggle_submission(cfg, trainer.predict(z_te),
                                          pred_val))
    write_results_csv(cfg.stage_dir, "predictor", metrics)
    mark_stage_done(cfg.stage_dir, "predictor")
    return metrics


def _kaggle_submission(cfg: ExperimentConfig, preds, test_ds) -> dict:
    """The galaxy predictor's submission file and its results fields."""
    out = {}
    ids = getattr(test_ds, "ids", None)
    if ids is None and getattr(test_ds, "synthetic", False):
        # a plumbing check on synthetic data: positional ids, flagged so
        # that the file is not taken for an uploadable one
        ids = np.arange(len(preds)) + 1
        out["kaggle_submission_ids"] = "synthetic_positional"
    if ids is None:
        # a train-derived split has no kaggle ids: made-up ids would
        # score garbage
        out["kaggle_submission"] = "skipped_no_ids"
        return out
    out["kaggle_submission"] = str(write_kaggle_submission(
        ids, preds, Path(cfg.stage_dir) / "kaggle_submission.csv"))
    return out


def main(cfg: ExperimentConfig, device=None) -> dict:
    """The three stages, each skipped when its sentinel exists. Returns
    the metrics of the stages that ran. With `trainer.n_devices` > 1 and
    no process group, the stages run in that many spawned ranks (module
    docstring) and this returns rank 0's metrics."""
    device = resolve_device(device)
    cfg = apply_precision(copy.deepcopy(cfg))
    n_ranks = _training_mesh(cfg, device)
    rank, world = mesh.rank_world()
    if world == 1 and n_ranks > 1:
        return _spawn_ranks(cfg, device, n_ranks)
    stage_dir = cfg.stage_dir
    all_metrics = {}

    trained = not is_stage_done(stage_dir, "featurizer")
    if trained:
        state, train_ds, test_ds, m = run_featurizer_stage(cfg, device)
        all_metrics.update(m)
    if rank != 0:   # rank 0 alone evaluates, codes and probes
        return all_metrics
    if not trained:
        # rebuild from the exported weights for the downstream stages
        train_ds = instantiate_datamodule(cfg, cfg.data_feat, device=device)
        test_ds = _test_dataset(cfg, cfg.data_feat, device)
        weights_path = Path(cfg.ckpt_dir) / cfg.long_name / "best_featurizer"
        if resolve_swap(weights_path.absolute()) is None:
            raise FileNotFoundError(
                f"featurizer stage is marked done (sentinel in "
                f"{stage_dir}) but its exported weights are missing at "
                f"{weights_path}. Either point ckpt_dir at the directory "
                f"used for that run, or delete the stage sentinel to "
                f"retrain.")
        state = build_state(cfg, 0, device=device)
        state.model.load_state_dict(load_weights(weights_path))

    if not cfg.is_skip_comm and not is_stage_done(stage_dir,
                                                  "communication"):
        comm_ds = test_ds if cfg.data_pred is None \
            else _test_dataset(cfg, cfg.data_pred, device)
        bs = _fit_bsz(cfg.data_feat.val_batch_size, len(comm_ds))
        all_metrics.update(run_communication(
            cfg, state, comm_ds.batches(bs, n_epochs=1,
                                        seed=cfg.trainer.seed), device))

    if not cfg.is_only_feat and not is_stage_done(stage_dir, "predictor"):
        all_metrics.update(
            run_predictor(cfg, state, train_ds, test_ds, device))
    return all_metrics


def _spawn_ranks(cfg: ExperimentConfig, device, n: int) -> dict:
    """`main(cfg)` in `n` spawned ranks of a process group (NCCL over cards
    0..n-1, or gloo on the CPU); rank 0's metrics."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_rank_main, args=(n, cfg, device.type,
                                         mesh.free_port(), queue),
                       nprocs=n, start_method="spawn")
    return queue.get()


def _rank_main(rank: int, world: int, cfg: ExperimentConfig,
               device_type: str, port: int, queue):
    """One spawned rank: torchrun's environment, the group, `main`."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if device_type == "cuda":
        device = torch.device("cuda", rank)
    else:          # the ranks share the host's cores
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh.init_distributed(device)
    try:
        metrics = main(cfg, device)
        if rank == 0:
            queue.put(metrics)
    finally:
        torch.distributed.destroy_process_group()
