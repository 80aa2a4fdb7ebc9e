"""Training state: optimizer groups, schedules, train and eval steps,
checkpoints, loggers and metrics."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "CheckpointManager": ".checkpoints", "is_stage_done": ".checkpoints",
    "mark_stage_done": ".checkpoints", "get_logger": ".loggers",
    "MetricAccumulator": ".metrics", "write_results_csv": ".metrics",
    "OptimConfig": ".state", "TrainState": ".state",
    "eval_step": ".state", "make_generative_epoch": ".state",
    "train_step": ".state"})
