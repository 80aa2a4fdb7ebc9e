"""Stage sentinels and the weights-only export.

Counterpart of part of `lossyless_tpu/train/checkpoints.py`:

* stage sentinels `{stage}_end.txt`: a finished stage is skipped on
  restart;
* `save_weights` / `load_weights`: a state dict written with `torch.save`
  (a file, where JAX writes an orbax directory) through the same tmp/old
  two-rename swap, and `resolve_swap`, which finds and heals a swap that a
  crash interrupted.

The semantics are JAX's, window for window: a `.tmp` with neither the
file nor its `.old` is a save that died before its swap began, and is not
read (kept as JAX keeps it, ROADMAP queue 3). A `.tmp` counts as complete
when it is a whole zip archive, which `torch.save` writes: the archive's
directory is written last. Orbax files are not read, and the resumable
`CheckpointManager` waits (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path

import torch


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


def save_weights(path, state_dict: dict):
    """Weights-only export: write `.tmp`, move the current file to `.old`,
    rename `.tmp` into place, drop `.old`, so a crash at any point leaves a
    complete file (or its healable swap leftovers)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    # finish an interrupted swap first, so the newest complete file is
    # never the `.tmp` removed below
    resolve_swap(path)
    tmp = path.with_name(path.name + ".tmp")
    old = path.with_name(path.name + ".old")
    tmp.unlink(missing_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    old.unlink(missing_ok=True)
    if path.exists():
        os.replace(path, old)
    os.replace(tmp, path)
    old.unlink(missing_ok=True)


def load_weights(path) -> dict:
    """The state dict of a `save_weights` export (through a swap window)."""
    path = Path(path).absolute()
    found = resolve_swap(path)
    if found is None:
        raise FileNotFoundError(f"no weights at {path}")
    return torch.load(found, map_location="cpu", weights_only=True)


def stage_sentinel(out_dir, stage: str) -> Path:
    return Path(out_dir) / f"{stage}_end.txt"


def is_stage_done(out_dir, stage: str) -> bool:
    return stage_sentinel(out_dir, stage).exists()


def mark_stage_done(out_dir, stage: str):
    p = stage_sentinel(out_dir, stage)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("done\n")
