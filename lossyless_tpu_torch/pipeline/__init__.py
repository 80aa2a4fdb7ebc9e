"""Experiment configuration, the three-stage pipeline, the probe and the
hyperparameter search."""
from .config import ExperimentConfig, apply_overrides, preset
from .hypopt import hypopt
from .predictor import PredictorConfig, PredictorTrainer, featurize_dataset
from .run import main

__all__ = ["ExperimentConfig", "apply_overrides", "preset", "hypopt",
           "PredictorConfig", "PredictorTrainer", "featurize_dataset", "main"]
