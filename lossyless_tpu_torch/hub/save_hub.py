"""Export a trained compressor's rate estimator to the hub format.

Counterpart of `lossyless_tpu/hub/save_hub.py`: extract the rate
estimator's parameters (affine + entropy bottleneck) and save them
standalone, so `hub.ClipCompressor` loads them next to the tower weights.
The files are the JAX package's: `factorized_rate.npz` (keys `scaling`,
`biasing`, `entropy_bottleneck._matrix{i}` ..., `entropy_bottleneck.
quantiles`) and the same tensors as a torch `factorized_rate.pt`. Each
side's `load_hub_npz` reads the other's file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def extract_rate_params(params) -> dict:
    """Rate-estimator params in the hub naming, as numpy arrays.

    `params` is a `LearnableCompressor` (or its state dict, names
    `rate_estimator.affine.*` and `rate_estimator.entropy_bottleneck.*`).
    """
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    affine, coder = {}, {}
    prefix = "rate_estimator."
    for name, v in params.items():
        if not name.startswith(prefix):
            continue
        sub, _, k = name[len(prefix):].partition(".")
        if sub == "affine":
            affine[k] = _np(v)
        elif sub == "entropy_bottleneck":
            coder["entropy_bottleneck.quantiles" if k == "quantiles"
                  else f"entropy_bottleneck._{k}"] = _np(v)
    # the JAX package's order: the affine, then the coder by name
    return {**{k: affine[k] for k in ("scaling", "biasing")},
            **dict(sorted(coder.items()))}


def save_hub(params, out_dir: str | Path, beta: float) -> Path:
    """Write `beta{beta:.0e}/factorized_rate.npz` and `.pt` under
    `out_dir`; returns that directory."""
    out = Path(out_dir) / f"beta{beta:.0e}"
    out.mkdir(parents=True, exist_ok=True)
    flat = extract_rate_params(params)
    np.savez(out / "factorized_rate.npz", **flat)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
               out / "factorized_rate.pt")
    return out


def load_hub_npz(path: str | Path):
    """Inverse of save_hub: returns (eb_params, scaling, biasing)."""
    data = np.load(path)
    eb_params, scaling, biasing = {}, None, None
    for k in data.files:
        if k == "scaling":
            scaling = data[k]
        elif k == "biasing":
            biasing = data[k]
        elif k.startswith("entropy_bottleneck."):
            eb_params[k.split(".", 1)[1].lstrip("_")] = data[k]
    return eb_params, scaling, biasing
