"""Pretrained encoder weights from a local file: `encoder.pretrained_path`.

Counterpart of the local branches of
`lossyless_tpu/nn/pretrained.py::load_pretrained_encoder`: the weights of
the compressor's encoder tower (`p_ZlX.mapper`, its BatchNorm running
statistics included) are overwritten, nothing else. Two forms are read:

* an export of the port's `train.checkpoints.save_weights` (a featurizer
  stage's `best_featurizer`, as `mnist_stag_step2` reads
  `mnist_stag_step1`'s): the whole compressor's state dict, whose
  `p_ZlX.mapper.` entries are taken, or the tower's own state dict;
* a flat `.npz` in JAX's layout: the tower's flax tree with `/`-joined
  keys, parameters under `params/` (or bare) and running statistics under
  `batch_stats/`, carried over by `layers.params_from_flax`.

Every loaded entry must name a tensor of the tower and match its shape;
entries the file lacks keep their initial values. The converters of
public torch checkpoints (torchvision, SimCLR, SwAV, CLIP's RN50) and
JAX's orbax export directories wait for ROADMAP queue 1 order 7b.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from ..train.checkpoints import load_weights, resolve_swap
from .layers import params_from_flax

PREFIX = "p_ZlX.mapper."


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _from_npz(path: Path) -> dict:
    """The tower's state dict from a flat `.npz` of its flax tree."""
    flat = dict(np.load(path))
    tree = _unflatten({k[len("params/"):] if k.startswith("params/") else k:
                       v for k, v in flat.items()
                       if not k.startswith("batch_stats/")})
    stats = _unflatten({k[len("batch_stats/"):]: v for k, v in flat.items()
                        if k.startswith("batch_stats/")})

    def merge(a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
        return out

    return params_from_flax(merge(tree, stats))


def _from_export(path: Path, target: dict) -> dict:
    """The tower's state dict from a `save_weights` export: a compressor's
    (its `p_ZlX.mapper.` entries) or the tower's own. A torch file of
    other names is a public checkpoint, whose converters wait."""
    sd = load_weights(path)
    mapper = {k[len(PREFIX):]: v for k, v in sd.items()
              if k.startswith(PREFIX)}
    if mapper:
        return mapper
    if sd and not set(sd) & set(target):
        raise NotImplementedError(
            f"{path} is not an export of this package: the converters of "
            f"public checkpoints (torchvision, SimCLR, SwAV, CLIP RN50) "
            f"are not ported yet (ROADMAP queue 1 order 7b)")
    return sd


def load_pretrained_encoder(encoder_cfg, model: torch.nn.Module,
                            path: str | None = None) -> torch.nn.Module:
    """Overwrite `model`'s encoder tower (`p_ZlX.mapper`: parameters and
    running statistics) with the weights at `path` (default
    `encoder_cfg.pretrained_path`), in place. Returns the model."""
    path = path or encoder_cfg.pretrained_path
    p = Path(path)
    target = {k[len(PREFIX):]: v for k, v in model.state_dict().items()
              if k.startswith(PREFIX)}
    if p.is_dir():
        raise NotImplementedError(
            f"{path}: JAX's orbax exports are not read (ROADMAP queue 1 "
            f"order 7b); pass a save_weights export of this package or a "
            f"flat .npz")
    if p.suffix == ".npz" and p.exists():
        loaded = _from_npz(p)
    elif p.suffix != ".npz" and resolve_swap(p.absolute()) is not None:
        loaded = _from_export(p, target)
    else:
        raise FileNotFoundError(
            f"encoder.pretrained_path={path!r} does not exist")

    problems = [f"{k}: {tuple(v.shape)} vs "
                f"{tuple(target[k].shape) if k in target else 'absent'}"
                for k, v in loaded.items()
                if k not in target or target[k].shape != v.shape]
    if problems:
        raise ValueError(
            f"{path}: the weights do not fit the encoder (p_ZlX.mapper) "
            f"(wrong architecture or checkpoint?):\n  "
            + "\n  ".join(problems[:12]))
    if any(k.endswith((".mean", ".var")) for k in target) and not any(
            k.endswith((".mean", ".var")) for k in loaded):
        warnings.warn(
            f"{path}: the encoder has BatchNorm statistics but the "
            f"checkpoint provides none; they stay at their initial values")
    with torch.no_grad():
        sd = model.state_dict()
        for k, v in loaded.items():
            sd[PREFIX + k].copy_(v)
    return model
