"""Experiment configuration, the three-stage pipeline, the probe and the
hyperparameter search."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "ExperimentConfig": ".config", "apply_overrides": ".config",
    "preset": ".config", "PredictorConfig": ".predictor",
    "PredictorTrainer": ".predictor", "featurize_dataset": ".predictor",
    "main": ".run"})

# the function, bound eagerly: its submodule has its name, and this import
# binds the function over the submodule that the import system binds first
from .hypopt import hypopt  # noqa: E402

__all__ += ["hypopt"]
