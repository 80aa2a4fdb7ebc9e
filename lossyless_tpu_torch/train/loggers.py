"""Training loggers: CSV (the default), wandb (optional), none.

Counterpart of `lossyless_tpu/train/loggers.py`. One difference: asked
for wandb where it is not installed, `get_logger` raises instead of
writing CSV in its place. Under a data-parallel process group only rank
0 logs (the other ranks get `NoLogger`): the logs are the global batch's
on every rank.
"""

from __future__ import annotations


class NoLogger:
    def log(self, step: int, logs: dict):
        pass

    def finish(self):
        pass


class CsvTrainLogger:
    def __init__(self, out_dir, name: str = "metrics"):
        from .metrics import CsvLogger

        self._csv = CsvLogger(out_dir, name)

    def log(self, step: int, logs: dict):
        self._csv.log(step, logs)

    def finish(self):
        pass


class WandbLogger:
    def __init__(self, out_dir, project: str, experiment: str,
                 run_id: str | None = None, config: dict | None = None):
        try:
            import wandb  # optional dependency
        except ImportError as e:
            raise RuntimeError(
                "trainer.logger=wandb but wandb is not installed; use csv "
                "or none") from e
        self._run = wandb.init(
            project=project, group=experiment, id=run_id, resume="allow",
            dir=str(out_dir), config=config or {})

    def log(self, step: int, logs: dict):
        self._run.log({k: float(v) for k, v in logs.items()}, step=step)

    def finish(self):
        self._run.finish()


def get_logger(mode: str, out_dir, experiment: str = "dev",
               name: str = "metrics", **kwargs):
    """`name` is the CSV file stem of the csv mode."""
    from ..core.mesh import rank_world

    if mode in (None, "none") or rank_world()[0] != 0:
        return NoLogger()
    if mode == "csv":
        return CsvTrainLogger(out_dir, name)
    if mode == "wandb":
        return WandbLogger(out_dir, project=kwargs.pop("project",
                                                       "lossyless_tpu"),
                           experiment=experiment, **kwargs)
    raise ValueError(f"unknown logger mode {mode}")
