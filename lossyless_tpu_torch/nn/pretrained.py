"""Pretrained encoder weights from a local file: `encoder.pretrained_path`.

Counterpart of `lossyless_tpu/nn/pretrained.py::load_pretrained_encoder`:
the weights of the compressor's encoder tower (`p_ZlX.mapper`, its
BatchNorm running statistics included) are overwritten, nothing else.
Three forms are read:

* an export of the port's `train.checkpoints.save_weights` (a featurizer
  stage's `best_featurizer`, as `mnist_stag_step2` reads
  `mnist_stag_step1`'s): the whole compressor's state dict, whose
  `p_ZlX.mapper.` entries are taken, or the tower's own state dict;
* a public torch checkpoint (`.pt`, `.pth`, `.bin`; the state dict at the
  top level or nested under `state_dict`, `model_state_dict` or `model`)
  converted by `encoder.arch`: OpenAI CLIP's ViT (`clip`, `clip_vit`:
  `nn.vit.convert_openai_clip_weights`) and RN50 (`clip_rn50`:
  `nn.clip_resnet.convert_clip_resnet`), both bare or under `visual.`;
  torchvision's ResNets and the SimCLR / SwAV backbones (`simclr`, `swav`,
  `resnet`: `nn.convert_resnet.convert_torchvision_resnet` at
  `arch_kwargs.base`, default resnet50), with the SSL prefixes of
  `_SSL_PREFIXES` stripped;
* a flat `.npz` in JAX's layout: the tower's flax tree with `/`-joined
  keys, parameters under `params/` (or bare) and running statistics under
  `batch_stats/`, carried over by `layers.params_from_flax`.

A positional embedding over a lead token and a square grid (the ViT's
patches, the RN50 pool's tokens) whose grid differs from the tower's is
resampled on both grid axes by `jax.image.resize`'s cubic matrices
(`nn.vit.cubic_weight_mat`), the lead token kept as it is: checkpoints are
published at 224 px, the ssl presets train at 96. Every loaded entry must
then name a tensor of the tower and match its shape; entries the file
lacks keep their initial values. A tower with BatchNorm statistics loaded
from a file without them warns.

JAX also reads its orbax export directories; those need orbax and
tensorstore, which this package does not use, so a directory is refused
with the formats above named.
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path

import numpy as np
import torch

from ..train.checkpoints import resolve_swap
from .clip_resnet import convert_clip_resnet
from .convert_resnet import convert_torchvision_resnet
from .layers import merge_stats, params_from_flax
from .vit import convert_openai_clip_weights, cubic_weight_mat

PREFIX = "p_ZlX.mapper."
# prefixes of public SSL ResNet-50 checkpoints (pl_bolts SimCLR / SwAV,
# torchvision supervised); tried longest first until the layer keys resolve
_SSL_PREFIXES = ("module.encoder.", "encoder.", "module.", "model.",
                 "backbone.", "")
CONVERTERS = "clip/clip_vit (OpenAI CLIP ViT), clip_rn50 (OpenAI CLIP " \
             "RN50), simclr/swav/resnet (torchvision layout)"
FORMATS = ("a save_weights export of this package, a public torch "
           f"checkpoint (.pt/.pth/.bin; converters: {CONVERTERS}) or a "
           "flat .npz of the tower's flax tree")


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
    return params_from_flax(merge_stats(tree, stats))


def _load_torch_state_dict(path: Path) -> dict:
    """A torch file's state dict: the top level, or nested under a
    well-known key."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model_state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(obj)}")
    return obj


def _strip_ssl_prefix(sd: dict) -> dict:
    for pref in _SSL_PREFIXES:
        if any(k.startswith(pref + "conv1.") for k in sd):
            return {k[len(pref):]: v for k, v in sd.items()
                    if k.startswith(pref)}
    return sd


def _convert_for_arch(arch: str, sd: dict, base: str = "resnet50") -> dict:
    """A public torch state dict -> the tower's state dict."""
    try:
        if arch in ("clip", "clip_vit"):
            return convert_openai_clip_weights(sd)
        if arch == "clip_rn50":
            return convert_clip_resnet(sd)
        if arch in ("simclr", "swav", "resnet"):
            params, stats = convert_torchvision_resnet(_strip_ssl_prefix(sd),
                                                       base=base)
            return params_from_flax(merge_stats(params, stats))
    except (KeyError, ValueError) as e:
        raise ValueError(
            f"the checkpoint is not in the layout of the converter for "
            f"encoder.arch={arch!r} ({type(e).__name__}: {e}); supported: "
            f"{CONVERTERS}") from e
    raise ValueError(
        f"no pretrained-weight converter for encoder.arch={arch!r} "
        f"(supported: {CONVERTERS})")


def _from_torch_file(path: Path, encoder_cfg, target: dict) -> dict:
    """The tower's state dict from a torch file: a `save_weights` export
    (a compressor's `p_ZlX.mapper.` entries, or the tower's own), else a
    public checkpoint converted by `encoder.arch`."""
    sd = _load_torch_state_dict(path)
    mapper = {k[len(PREFIX):]: v for k, v in sd.items()
              if k.startswith(PREFIX)}
    if mapper:
        return mapper
    if sd and set(sd) & set(target):
        return sd
    return _convert_for_arch(encoder_cfg.arch, sd,
                             encoder_cfg.arch_kwargs.get("base", "resnet50"))


def resample_positional_embedding(pe: torch.Tensor, n_tokens: int):
    """A (1 + g^2, C) positional embedding resampled to `n_tokens` = 1 +
    g'^2 rows: the g x g grid through `jax.image.resize(..., "cubic")`'s
    matrices on both axes (fp32), the lead row kept bit for bit. None
    where either count is not 1 + a square."""
    g_src = math.isqrt(pe.shape[0] - 1)
    g_dst = math.isqrt(n_tokens - 1)
    if g_src * g_src + 1 != pe.shape[0] or g_dst * g_dst + 1 != n_tokens:
        return None
    w = cubic_weight_mat(g_src, g_dst)
    grid = pe[1:].float().reshape(g_src, g_src, -1)
    grid = torch.einsum("hwc,hH->Hwc", grid, w)
    grid = torch.einsum("hwc,wW->hWc", grid, w)
    return torch.cat([pe[:1], grid.reshape(g_dst * g_dst, -1).to(pe.dtype)])


def _adapt_positional_embeddings(target: dict, loaded: dict) -> dict:
    """Resample each loaded positional embedding whose token grid differs
    from the tower's (`resample_positional_embedding`); anything else that
    differs falls through to the shape check's error."""
    out = dict(loaded)
    for k, v in loaded.items():
        want = target.get(k)
        if (not k.endswith("positional_embedding") or want is None
                or v.dim() != 2 or want.dim() != 2
                or want.shape[1] != v.shape[1] or want.shape == v.shape):
            continue
        pe = resample_positional_embedding(v, want.shape[0])
        if pe is not None:
            out[k] = pe
    return out


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
            f"{path} is a directory (JAX's orbax export, which needs orbax "
            f"and tensorstore); this package reads {FORMATS}")
    found = None if p.suffix == ".npz" else resolve_swap(p.absolute())
    if p.suffix == ".npz" and p.exists():
        loaded = _from_npz(p)
    elif found is not None:
        loaded = _from_torch_file(found, encoder_cfg, target)
    else:
        raise FileNotFoundError(
            f"encoder.pretrained_path={path!r} does not exist")
    loaded = _adapt_positional_embeddings(target, {
        k: torch.as_tensor(v) for k, v in loaded.items()})

    problems = [f"{k}: {tuple(v.shape)} vs "
                f"{tuple(target[k].shape) if k in target else 'absent'}"
                for k, v in loaded.items()
                if k not in target or target[k].shape != v.shape]
    if problems:
        raise ValueError(
            f"{path}: the weights do not fit the encoder (p_ZlX.mapper) "
            f"(is encoder.arch/z_dim/arch_kwargs consistent with the "
            f"checkpoint?):\n  " + "\n  ".join(problems[:12]))
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
