"""Load the reference's published rate-estimator checkpoints.

The reference ships rate-estimator-only state dicts as
`hub/beta{1e-02,5e-02,1e-01}/factorized_rate.pt` (keys `scaling`,
`biasing`, `entropy_bottleneck._matrix{k}/_bias{k}/_factor{k}`,
`entropy_bottleneck.quantiles`; the CDF buffers are empty and rebuilt on
load). This module maps them onto the entropy-bottleneck parameter dict.

A beta name resolves under `reference/hub/` at the root of the checkout,
where the published files go once they are in the repository; any other
argument is taken as a path to such a file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

REFERENCE_HUB = Path(__file__).resolve().parents[2] / "reference" / "hub"
BETA_DIRS = {"b001": "beta1e-02", "b005": "beta5e-02", "b01": "beta1e-01"}


def reference_path(path_or_beta="b005") -> Path:
    path = Path(path_or_beta)
    if not path.exists() and str(path_or_beta) in BETA_DIRS:
        path = REFERENCE_HUB / BETA_DIRS[str(path_or_beta)] / \
            "factorized_rate.pt"
    return path


def load_factorized_rate(path_or_beta="b005"):
    """Return (eb_params, scaling, biasing) as numpy float32 arrays."""
    path = reference_path(path_or_beta)
    if not path.exists():
        raise FileNotFoundError(
            f"published rate weights not found at {path}; they are not part "
            f"of this checkout")
    sd = torch.load(path, map_location="cpu")

    def np_(k):
        return sd[k].detach().numpy().astype(np.float32)

    eb_params = {}
    i = 0
    while f"entropy_bottleneck._matrix{i}" in sd:
        eb_params[f"matrix{i}"] = np_(f"entropy_bottleneck._matrix{i}")
        eb_params[f"bias{i}"] = np_(f"entropy_bottleneck._bias{i}")
        if f"entropy_bottleneck._factor{i}" in sd:
            eb_params[f"factor{i}"] = np_(f"entropy_bottleneck._factor{i}")
        i += 1
    eb_params["quantiles"] = np_("entropy_bottleneck.quantiles")

    scaling = np_("scaling")
    biasing = np_("biasing")
    return eb_params, scaling, biasing
