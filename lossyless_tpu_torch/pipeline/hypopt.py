"""Hyperparameter search over pipeline runs.

Counterpart of `lossyless_tpu/pipeline/hypopt.py` (the reference's Optuna
sweeper). The built-in searcher does random search over dotted
override spaces, with opt-in **median-stop pruning** (`prune=True`): each
trial first runs a short featurizer-only "rung" (`rung_fraction` of the
epochs); trials whose rung loss is worse than the median of previous rungs
are stopped there, and surviving trials continue to the full budget by
RESUMING from the rung's checkpoint (the pipeline's preemption-resume
machinery — no rung work is wasted). If `optuna` is importable it is used
transparently instead (with its own MedianPruner when `prune=True`).

Search-space spec: {"loss.beta": ("log_uniform", 1e-3, 1.0),
                    "encoder.z_dim": ("choice", [32, 64, 128])}.
"""

from __future__ import annotations

import copy
import functools
import json
import math
from pathlib import Path

import numpy as np


def _sample(space: dict, rng: np.random.Generator) -> dict:
    out = {}
    for key, spec in space.items():
        kind = spec[0]
        if kind == "uniform":
            out[key] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "log_uniform":
            out[key] = float(np.exp(rng.uniform(math.log(spec[1]),
                                                math.log(spec[2]))))
        elif kind == "choice":
            out[key] = spec[1][rng.integers(len(spec[1]))]
        elif kind == "int":
            out[key] = int(rng.integers(spec[1], spec[2] + 1))
        else:
            raise ValueError(f"unknown spec kind {kind}")
    return out


def _run_rung(cfg, run_fn, rung_fraction: float) -> tuple[float, int]:
    """A trial's rung: a short featurizer-only run at `rung_fraction` of
    its epochs (at least one), under `<out_dir>/rungs`. Returns its
    featurizer test loss (a lower-better proxy for any monitor; a missing
    or non-finite one is inf) and its epochs. The trial's full run, with
    the same checkpoint directory and experiment name, resumes from the
    rung's last checkpoint."""
    rung_cfg = copy.deepcopy(cfg)
    rung_cfg.data_feat = copy.deepcopy(cfg.data_feat)
    rung_cfg.data_feat.n_epochs = max(
        1, int(cfg.data_feat.n_epochs * rung_fraction))
    rung_cfg.is_only_feat = True
    rung_cfg.is_skip_comm = True
    rung_cfg.out_dir = str(Path(cfg.out_dir) / "rungs")
    rv = run_fn(rung_cfg).get("test/feat/loss", math.inf)
    if rv is None or not np.isfinite(rv):
        rv = math.inf
    return float(rv), rung_cfg.data_feat.n_epochs


def hypopt(base_cfg, space: dict, monitor: str, n_trials: int = 10,
           direction: str = "minimize", seed: int = 0,
           run_fn=None, out_file: str | None = None, prune: bool = False,
           rung_fraction: float = 0.25, device=None) -> dict:
    """Random-search the override space; returns the best trial record.

    `run_fn(cfg) -> metrics dict` defaults to the full pipeline `main` on
    `device` (the card unless given).
    `prune=True` enables median-stop pruning: a featurizer-only rung run at
    `rung_fraction` of the epochs gates the full run (see module docstring);
    pruned trials are recorded with the worst value and `"pruned": True`.
    """
    from .config import apply_overrides

    if run_fn is None:
        from .run import main
        run_fn = functools.partial(main, device=device)

    # availability check only — a later ImportError INSIDE a trial must
    # propagate, not silently restart the whole search with the built-in
    # random searcher (discarding completed optuna trials)
    try:
        import optuna  # noqa: F401
        has_optuna = True
    except ImportError:
        has_optuna = False
    if has_optuna:
        return _hypopt_optuna(base_cfg, space, monitor, n_trials, direction,
                              seed, run_fn, out_file, prune, rung_fraction)

    rng = np.random.default_rng(seed)
    worst = math.inf if direction == "minimize" else -math.inf
    trials = []
    rung_vals: list[float] = []
    for t in range(n_trials):
        params = _sample(space, rng)
        overrides = [f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
                     for k, v in params.items()]
        cfg = apply_overrides(copy.deepcopy(base_cfg), overrides)
        cfg.trainer.seed = seed + t
        cfg.experiment = f"{base_cfg.experiment}_trial{t}"

        if prune and cfg.data_feat.n_epochs >= 2:
            # median-stop vs all previous rungs
            rv, _ = _run_rung(cfg, run_fn, rung_fraction)
            if len(rung_vals) >= 2 and rv > float(np.median(rung_vals)):
                rung_vals.append(rv)
                trials.append({"trial": t, "params": params,
                               "value": float(worst), "pruned": True,
                               "rung_value": rv, "metrics": {}})
                continue
            rung_vals.append(rv)
            # the full run below RESUMES from the rung's last checkpoint
            # (same ckpt_dir + experiment name -> same checkpoint path)

        metrics = run_fn(cfg)
        value = metrics.get(monitor)
        # a NaN or missing monitor is the worst value
        if value is None or not np.isfinite(value):
            value = worst
        trials.append({"trial": t, "params": params, "value": float(value),
                       "metrics": {k: v for k, v in metrics.items()
                                   if isinstance(v, (int, float))}})

    best = (min if direction == "minimize" else max)(
        trials, key=lambda r: r["value"])
    result = {"best": best, "trials": trials, "monitor": monitor,
              "direction": direction}
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(json.dumps(result, indent=2, default=str))
    return result


def _hypopt_optuna(base_cfg, space, monitor, n_trials, direction, seed,
                   run_fn, out_file, prune=False, rung_fraction=0.25):
    import optuna  # noqa — optional

    from .config import apply_overrides

    def objective(trial):
        params = {}
        for key, spec in space.items():
            kind = spec[0]
            name = key.replace(".", "__")
            if kind == "uniform":
                params[key] = trial.suggest_float(name, spec[1], spec[2])
            elif kind == "log_uniform":
                params[key] = trial.suggest_float(name, spec[1], spec[2],
                                                  log=True)
            elif kind == "choice":
                params[key] = trial.suggest_categorical(name, spec[1])
            elif kind == "int":
                params[key] = trial.suggest_int(name, spec[1], spec[2])
        overrides = [f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
                     for k, v in params.items()]
        cfg = apply_overrides(copy.deepcopy(base_cfg), overrides)
        cfg.experiment = f"{base_cfg.experiment}_optuna{trial.number}"
        worst = math.inf if direction == "minimize" else -math.inf

        if prune and cfg.data_feat.n_epochs >= 2:
            # the rung is reported as the intermediate value so the
            # MedianPruner can act; the full run below resumes from the
            # rung's checkpoint
            rv, rung_epochs = _run_rung(cfg, run_fn, rung_fraction)
            # the rung metric is lower-better regardless of direction
            trial.report(rv if direction == "minimize" else -rv,
                         step=rung_epochs)
            if trial.should_prune():
                raise optuna.TrialPruned()

        metrics = run_fn(cfg)
        # failed/missing trials must be the WORST value for the direction
        # (None-valued monitors included, like the built-in searcher)
        value = metrics.get(monitor)
        if value is None or not np.isfinite(value):
            value = worst
        return value

    pruner = optuna.pruners.MedianPruner() if prune else None
    study = optuna.create_study(direction=direction, pruner=pruner)
    study.optimize(objective, n_trials=n_trials)
    # the built-in searcher's result contract (out_file keeps the
    # per-trial records either way)
    worst = math.inf if direction == "minimize" else -math.inf
    trials = [{"trial": t.number,
               "params": {k.replace("__", "."): v
                          for k, v in t.params.items()},
               "value": float(t.value) if t.value is not None
               else float(worst),
               "pruned": t.state.name == "PRUNED"}
              for t in study.trials]
    result = {"best": {"params": {k.replace("__", "."): v
                                  for k, v in study.best_params.items()},
                       "value": study.best_value},
              "trials": trials, "monitor": monitor,
              "direction": direction}
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(json.dumps(result, indent=2, default=str))
    return result
