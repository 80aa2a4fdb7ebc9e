"""Galaxy Zoo's kaggle submission writer.

Counterpart of `lossyless_tpu/analysis/kaggle.py`: the predictor stage of
`galaxy_regression` writes its predictions over the test split as the
challenge's submission CSV (GalaxyID and 37 probability columns).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

GALAXY_COLUMNS = [
    "Class1.1", "Class1.2", "Class1.3", "Class2.1", "Class2.2", "Class3.1",
    "Class3.2", "Class4.1", "Class4.2", "Class5.1", "Class5.2", "Class5.3",
    "Class5.4", "Class6.1", "Class6.2", "Class7.1", "Class7.2", "Class7.3",
    "Class8.1", "Class8.2", "Class8.3", "Class8.4", "Class8.5", "Class8.6",
    "Class8.7", "Class9.1", "Class9.2", "Class9.3", "Class10.1", "Class10.2",
    "Class10.3", "Class11.1", "Class11.2", "Class11.3", "Class11.4",
    "Class11.5", "Class11.6",
]


def write_kaggle_submission(ids, predictions, out_path: str | Path) -> Path:
    """Write `predictions` (N, 37), clipped to [0, 1], under their
    GalaxyIDs `ids` (N,) to `out_path`; returns the path."""
    predictions = np.clip(np.asarray(predictions, np.float64), 0.0, 1.0)
    if predictions.shape[1] != len(GALAXY_COLUMNS):
        raise ValueError(
            f"expected {len(GALAXY_COLUMNS)} columns, got "
            f"{predictions.shape[1]}")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["GalaxyID"] + GALAXY_COLUMNS)
        for gid, row in zip(ids, predictions):
            w.writerow([int(gid)] + [f"{v:.6f}" for v in row])
    return out_path
