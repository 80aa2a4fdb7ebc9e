"""Checkpoints, resume, stage sentinels and the weights-only export.

Counterpart of `lossyless_tpu/train/checkpoints.py`:

* `CheckpointManager`: a `last` checkpoint saved each epoch, from which a
  run resumes, and one `best` by the monitored metric (a NaN is never
  best), with `meta.json` holding `last_step`, `best_value` and
  `best_step`. A checkpoint is one `torch.save` of the train state (the
  model's and the optimizers' state, the step and the plateau scales), a
  file where JAX writes an orbax directory;
* stage sentinels `{stage}_end.txt`: a finished stage is skipped on
  restart;
* `save_weights` / `load_weights`: a state dict written with `torch.save`;
* every save goes through the same tmp/old two-rename swap, and
  `resolve_swap` finds and heals a swap that a crash interrupted.

The semantics are JAX's, window for window: a `.tmp` with neither the
file nor its `.old` is a save that died before its swap began, and is not
read (kept as JAX keeps it, ROADMAP queue 3). A `.tmp` counts as complete
when it is a whole zip archive, which `torch.save` writes: the archive's
directory is written last. Orbax files are not read.

Under a data-parallel process group (`core/mesh.py`) only rank 0 writes:
checkpoints, their `meta.json`, exports and sentinels; every rank reads a
checkpoint to resume.
"""

from __future__ import annotations

import json
import math
import os
import zipfile
from pathlib import Path

import torch

from ..core import mesh


def _complete(path: Path) -> bool:
    """True when `path` holds a whole `torch.save` archive."""
    return path.is_file() and zipfile.is_zipfile(path)


def resolve_swap(path: Path) -> Path | None:
    """The file written by the tmp/old swap at `path`, healing a swap a
    crash interrupted: with no `path`, a complete `.tmp` (the newest) or
    else the `.old` is renamed back to `path`, the other dropped. Healing
    failures (a read-only file system) return the survivor unhealed. None
    when there is no checkpoint."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    old = path.with_name(path.name + ".old")
    if path.exists():
        return path
    if old.exists():
        if _complete(tmp):
            try:
                os.replace(tmp, path)
                old.unlink()
                return path
            except OSError:
                return tmp
        try:
            os.replace(old, path)
            tmp.unlink(missing_ok=True)  # partial leftover of the dead save
            return path
        except OSError:
            return old
    return None


def _swap_save(path, obj):
    """`torch.save` through the swap: write `.tmp`, move the current file
    to `.old`, rename `.tmp` into place, drop `.old`, so a crash at any
    point leaves a complete file (or its healable swap leftovers)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    # finish an interrupted swap first, so the newest complete file is
    # never the `.tmp` removed below
    resolve_swap(path)
    tmp = path.with_name(path.name + ".tmp")
    old = path.with_name(path.name + ".old")
    tmp.unlink(missing_ok=True)
    torch.save(obj, tmp)
    old.unlink(missing_ok=True)
    if path.exists():
        os.replace(path, old)
    os.replace(tmp, path)
    old.unlink(missing_ok=True)


def save_weights(path, state_dict: dict):
    """Weights-only export of a state dict, through the swap (rank 0)."""
    if not _writes():
        return
    _swap_save(path, {k: v.detach().cpu() for k, v in state_dict.items()})


def load_weights(path) -> dict:
    """The state dict of a `save_weights` export (through a swap window)."""
    path = Path(path).absolute()
    found = resolve_swap(path)
    if found is None:
        raise FileNotFoundError(f"no weights at {path}")
    return torch.load(found, map_location="cpu", weights_only=True)


class CheckpointManager:
    """`last` and `best` checkpoints of a train state under `ckpt_dir`."""

    def __init__(self, ckpt_dir, monitor: str = "loss", mode: str = "min"):
        self.dir = Path(ckpt_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self._meta_path = self.dir / "meta.json"

    def _load_meta(self) -> dict:
        if self._meta_path.exists():
            return json.loads(self._meta_path.read_text())
        return {"best_value": None, "last_step": None}

    def _save_meta(self, meta: dict):
        self._meta_path.write_text(json.dumps(meta))

    def save_last(self, state, step: int):
        if not _writes():
            return
        _swap_save(self.dir / "last", state.state_dict())
        meta = self._load_meta()
        meta["last_step"] = int(step)
        self._save_meta(meta)

    def maybe_save_best(self, state, step: int, value: float) -> bool:
        """Keep exactly one best checkpoint. A NaN monitor (a diverged
        epoch) is never best: a first-epoch NaN would otherwise be saved
        and never superseded."""
        if value is None or math.isnan(value) or not _writes():
            return False
        meta = self._load_meta()
        best = meta.get("best_value")
        better = (best is None or math.isnan(best) or
                  (value < best if self.mode == "min" else value > best))
        if better:
            _swap_save(self.dir / "best", state.state_dict())
            meta["best_value"] = float(value)
            meta["best_step"] = int(step)
            self._save_meta(meta)
        return better

    def restore(self, state, which: str = "last"):
        """Load checkpoint `which` into `state` (in place) and return it;
        None when there is none."""
        path = resolve_swap(self.dir / which)
        if path is None:
            return None
        return state.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))

    @property
    def has_last(self) -> bool:
        return resolve_swap(self.dir / "last") is not None

    @property
    def best_value(self):
        return self._load_meta().get("best_value")


def stage_sentinel(out_dir, stage: str) -> Path:
    return Path(out_dir) / f"{stage}_end.txt"


def is_stage_done(out_dir, stage: str) -> bool:
    return stage_sentinel(out_dir, stage).exists()


def _writes() -> bool:
    """Whether this process writes (rank 0 of a process group, or no
    group)."""
    return mesh.rank_world()[0] == 0


def mark_stage_done(out_dir, stage: str):
    if not _writes():
        return
    p = stage_sentinel(out_dir, stage)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("done\n")
