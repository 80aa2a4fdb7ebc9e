"""Train state: one update over three optimizer groups.

Counterpart of `lossyless_tpu/train/state.py`. The combined objective is
differentiated once and the parameters are split into groups by path:

* "coder"  — entropy-model quantiles (paths with a `quantiles` component),
* "online" — the online probe (paths through `online_evaluator`),
* "main"   — everything else,
* "frozen" — paths through a component named in `frozen_paths`: these get
  `requires_grad_(False)` and belong to no optimizer (JAX zeroes their
  updates with `optax.set_to_zero`).

Schedules are plain functions of the update count that return what the
optax schedule returns at that count; a plateau group's lr is also scaled
by its host controller (`ReduceLROnPlateau`), as JAX scales the update. The optimizers are torch's, set up to
follow optax: adamw with decoupled decay, adam and sgd (momentum 0.9) with
torch-style coupled L2. `train_step` updates the state in place (the model
parameters and optimizer moments) and returns it with the step's logs;
`make_generative_epoch` runs an epoch of them on batches drawn on the
device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable

import numpy as np
import torch

from ..core import mesh
from ..core.profiling import span


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    mode: str = "adam"                   # adam|adamw|sgd
    lr: float = 3e-4
    weight_decay: float = 0.0
    # scheduler: {none, expdecay, unifmultistep, cosine, cosine_restart,
    # plateau}
    scheduler: str = "none"
    decay_factor: float = 1000.0
    k_steps: int = 3
    total_steps: int = 10000
    steps_per_epoch: int = 0
    restart_t0_epochs: int = 5           # cosine_restart T_0 (epochs)
    restart_mult: int = 2                # cosine_restart T_mult
    plateau_factor: float = 0.2
    plateau_patience: int = 10
    plateau_threshold: float = 1e-4
    plateau_min_lr: float = 1e-7


def _cosine(lr: float, decay_steps: int) -> Callable[[int], float]:
    # optax.cosine_decay_schedule(lr, decay_steps, alpha=0)
    def f(count):
        t = min(count, decay_steps) / decay_steps
        return lr * 0.5 * (1.0 + math.cos(math.pi * t))
    return f


def _make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count. "plateau" is
    a constant lr times the host controller's scale (`ReduceLROnPlateau`,
    `TrainState.lr_scales`), not a step schedule."""
    if cfg.scheduler in ("none", "plateau") or cfg.total_steps <= 0:
        # an unbound schedule (total_steps <= 0): constant lr
        return lambda count: cfg.lr
    if cfg.scheduler == "expdecay":
        # optax.exponential_decay(lr, total_steps, 1 / decay_factor)
        rate = 1.0 / cfg.decay_factor
        return lambda count: cfg.lr * rate ** (count / cfg.total_steps)
    if cfg.scheduler == "unifmultistep":
        k = cfg.k_steps
        gamma = (1.0 / cfg.decay_factor) ** (1.0 / k)
        # max(1,): with total_steps < k+1 the milestones would collapse
        delta = max(1, cfg.total_steps // (k + 1))
        bounds = sorted({delta * i for i in range(1, k + 1)})
        return lambda count: cfg.lr * gamma ** sum(count >= b for b in bounds)
    if cfg.scheduler == "cosine":
        return _cosine(cfg.lr, cfg.total_steps)
    if cfg.scheduler == "cosine_restart":
        spe = cfg.steps_per_epoch
        if spe <= 0:
            raise ValueError(
                "cosine_restart is epoch-denominated: bind steps_per_epoch "
                "via bind_schedule_steps(cfg, total, steps_per_epoch)")
        periods, t = [], max(1, cfg.restart_t0_epochs * spe)
        while sum(periods) < cfg.total_steps:
            periods.append(t)
            t *= max(1, cfg.restart_mult)
        starts = [0, *itertools.accumulate(periods)][:-1]
        pieces = [_cosine(cfg.lr, p) for p in periods]

        def restart(count):
            # optax.join_schedules: the last period whose start <= count
            i = max(j for j, s in enumerate(starts) if count >= s)
            return pieces[i](count - starts[i])
        return restart
    raise ValueError(f"unknown scheduler {cfg.scheduler}")


def bind_schedule_steps(cfg: OptimConfig, total_steps: int,
                        steps_per_epoch: int = 0) -> OptimConfig:
    """Fill an unbound schedule (total_steps <= 0) with the planned step
    count, and `steps_per_epoch` for the epoch-denominated schedulers."""
    if cfg.scheduler != "none":
        fills = {}
        if cfg.total_steps <= 0:
            fills["total_steps"] = max(0, total_steps)
        if cfg.steps_per_epoch <= 0 and steps_per_epoch > 0:
            fills["steps_per_epoch"] = steps_per_epoch
        if fills:
            return dataclasses.replace(cfg, **fills)
    return cfg


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau controller, torch ReduceLROnPlateau semantics
    (mode min/max, threshold_mode=rel, no cooldown). Feed one monitored
    value an epoch to `step()`; it returns the current lr scale (1.0 until
    the first reduction). The scale itself lives in the train state
    (`TrainState.lr_scales`) and its checkpoints, so a resumed run keeps
    its reduced lr; the patience counter restarts with the process."""

    factor: float = 0.2
    patience: int = 10
    threshold: float = 1e-4
    min_scale: float = 0.0
    mode: str = "min"
    best: float = dataclasses.field(default=None, init=False)  # type: ignore
    num_bad: int = dataclasses.field(default=0, init=False)
    scale: float = dataclasses.field(default=1.0, init=False)

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        if math.isfinite(metric) and self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.num_bad = 0
        return self.scale


def get_plateau_scale(state: "TrainState", label: str) -> float | None:
    """The lr scale of one group, or None when its scheduler is not
    plateau (re-seeds the host controller after a restore)."""
    return state.lr_scales.get(label)


def set_plateau_scale(state: "TrainState", scale: float,
                      label: str | None = None) -> "TrainState":
    """Set the lr scale of one plateau group (all of them without
    `label`); groups of another scheduler are untouched."""
    for lbl in state.lr_scales:
        if label is None or lbl == label:
            state.lr_scales[lbl] = float(scale)
    return state


def make_optimizer(cfg: OptimConfig, params) -> torch.optim.Optimizer:
    """The torch optimizer of one group; its lr is set from the schedule
    before every update (`train_step`)."""
    params = list(params)
    if cfg.mode == "adam":
        # coupled L2 (weight_decay added to the gradient), as the JAX
        # package chains add_decayed_weights before adam
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.mode == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.mode == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.mode}")


def param_label(name: str, frozen_paths: tuple = ()) -> str:
    """The group of a parameter, from its dotted state-dict name."""
    keys = name.split(".")
    if any(k in frozen_paths for k in keys):
        return "frozen"
    if "quantiles" in keys:
        return "coder"
    if "online_evaluator" in keys:
        return "online"
    return "main"


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    # label -> (optimizer, schedule); frozen params are in none of them
    optimizers: dict
    step: int = 0
    # label -> the plateau controller's lr scale, for the groups whose
    # scheduler is plateau (JAX keeps it in the optimizer state)
    lr_scales: dict = dataclasses.field(default_factory=dict)

    def state_dict(self) -> dict:
        """What a checkpoint holds: the model's and the optimizers' state,
        the step and the plateau scales."""
        return {"model": self.model.state_dict(),
                "optimizers": {label: opt.state_dict() for label, (opt, _)
                               in self.optimizers.items()},
                "step": self.step, "lr_scales": dict(self.lr_scales)}

    def load_state_dict(self, sd: dict) -> "TrainState":
        self.model.load_state_dict(sd["model"])
        for label, (opt, _) in self.optimizers.items():
            opt.load_state_dict(sd["optimizers"][label])
        self.step = int(sd["step"])
        self.lr_scales = dict(sd["lr_scales"])
        return self

    @classmethod
    def create(cls, model, main: OptimConfig,
               online: OptimConfig | None = None,
               coder: OptimConfig | None = None, frozen_paths: tuple = ()):
        cfgs = {"main": main, "online": online or main,
                "coder": coder or main}
        groups = {label: [] for label in cfgs}
        for name, p in model.named_parameters():
            label = param_label(name, tuple(frozen_paths))
            if label == "frozen":
                p.requires_grad_(False)
            else:
                groups[label].append(p)
        optimizers = {label: (make_optimizer(cfgs[label], ps),
                              _make_schedule(cfgs[label]))
                      for label, ps in groups.items() if ps}
        lr_scales = {label: 1.0 for label in optimizers
                     if cfgs[label].scheduler == "plateau"}
        return cls(model=model, optimizers=optimizers, lr_scales=lr_scales)


def train_step(state: TrainState, batch, generator=None, noise=None,
               eps=None):
    """One fused RD + coder update, in place. Returns (state, logs).
    `noise` / `eps` are the step's draws (`LearnableCompressor.step`),
    else they come from `generator`.

    Inside `core.mesh.data_parallel` the batch is this rank's rows and the
    step is the global batch's: the model's collectives (BatchNorm's
    statistics, the contrastive gather) and draws span the ranks, the
    gradients are averaged by one flat all-reduce after `backward`
    (`average_gradients`; DDP wraps a module's `forward`, while this state
    steps three optimizer groups through `model.step`), and the logs are
    the global batch's (`reduce_logs`).

    Under a profiler the step is three spans: `train.forward`,
    `train.backward` (with the gradient average) and `train.optimizer`
    (the rates set, the missing gradients filled, every `opt.step()`);
    the gradients are cleared before the forward and outlive the step."""
    x, y, aux = batch
    for opt, _ in state.optimizers.values():
        opt.zero_grad(set_to_none=True)
    with span("train.forward"):
        loss, logs = state.model.step(x, y, aux, training=True,
                                      step=state.step, generator=generator,
                                      noise=noise, eps=eps)
    dp = mesh.active() is not None
    with span("train.backward"):
        loss.backward()
        if dp:
            mesh.average_gradients(p for opt, _ in state.optimizers.values()
                                   for g in opt.param_groups
                                   for p in g["params"])
    if dp:
        logs = mesh.reduce_logs(logs)
    with span("train.optimizer"):
        for label, (opt, schedule) in state.optimizers.items():
            lr = schedule(state.step) * state.lr_scales.get(label, 1.0)
            for group in opt.param_groups:
                group["lr"] = lr
                for p in group["params"]:
                    # optax updates every param of a group each step (decay
                    # and moments included); torch skips a param without a
                    # grad
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            opt.step()
    state.step += 1
    return state, {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in logs.items()}


def epoch_generators(seed: int, device) -> tuple[torch.Generator,
                                                   torch.Generator]:
    """(data, step) generators on `device` for the epoch keyed by `seed`:
    two distinct streams, both functions of the seed alone."""
    data_seed, step_seed = np.random.SeedSequence(seed).generate_state(
        2, np.uint64)
    return (torch.Generator(device).manual_seed(int(data_seed)),
            torch.Generator(device).manual_seed(int(step_seed)))


def make_generative_epoch(sample_fn, n_steps: int, rank: int = 0,
                          world: int = 1, rows: int | None = None):
    """`epoch(state, seed) -> (state, logs)`: `n_steps` updates, each on a
    batch that `sample_fn(generator)` draws on the device (for example
    `BananaDataset.device_sampler`), with nothing copied from the host and
    no wait on the device inside the epoch.

    With `world` > 1 this process is rank `rank` of a data-parallel group
    and `sample_fn` draws its `rows` rows of each global batch: the epoch
    runs inside `core.mesh.data_parallel`, where every draw (the batch's
    and the steps') is the global batch's and the updates are the global
    batch's (`train_step`), so W ranks reproduce one device's epoch.

    The batches and the steps' own draws come from two generators seeded
    from `seed` (`epoch_generators`; the pipeline passes `trainer.seed +
    epoch`, as JAX keys the epoch), so an epoch's draws do not depend on
    the epochs before it and a resumed run draws what an unbroken one
    does. Each log comes back as a numpy array of shape (n_steps,), read
    from the device once an epoch. The steps are eager `train_step`s in a
    Python loop."""

    if (world > 1 or mesh.in_group()) and not rows:
        raise ValueError("a data-parallel epoch needs the rows a rank "
                         "draws of each global batch")

    def epoch(state: TrainState, seed: int):
        device = next(state.model.parameters()).device
        g_data, g_step = epoch_generators(seed, device)
        tensor_logs, host_logs = {}, {}
        for _ in range(n_steps):
            with mesh.data_parallel(rank, world, rows or 0):
                with span("train.sample"):
                    batch = sample_fn(g_data)
                state, logs = train_step(state, batch, g_step)
            for k, v in logs.items():
                (tensor_logs if isinstance(v, torch.Tensor)
                 else host_logs).setdefault(k, []).append(v)
        out = {k: np.asarray(v, np.float32) for k, v in host_logs.items()}
        if tensor_logs:
            stacked = torch.stack([torch.stack(v).float().reshape(n_steps)
                                   for v in tensor_logs.values()])
            out.update(zip(tensor_logs, stacked.cpu().numpy()))
        return state, out

    return epoch


@torch.no_grad()
def eval_step(state: TrainState, batch, generator=None,
              is_rate_only: bool = False):
    x, y, aux = batch
    return state.model.step(x, y, aux, training=False, step=state.step,
                            generator=generator, is_rate_only=is_rate_only)
