"""Pre-featurized datasets.

Counterpart of `lossyless_tpu/data/features.py` (`FeaturesDataset`):
feature arrays with their targets and, for `additional_target="equiv_x"`,
pre-featurized positives; `batches` yields `(x, target, aux)` in the JAX
order (one `default_rng(seed)` permutation an epoch), and `save` / `load`
use the same `.npz` keys (`features`, `targets`, `positives`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class FeaturesDataset:
    features: np.ndarray                    # (N, D)
    targets: np.ndarray                     # (N,) labels
    positives: np.ndarray | None = None     # (N, D) pre-featurized positives
    additional_target: str = "target"       # target|input|equiv_x

    def __post_init__(self):
        self.features = np.asarray(self.features, np.float32)
        self.targets = np.asarray(self.targets)
        if self.positives is not None:
            self.positives = np.asarray(self.positives, np.float32)

    def __len__(self):
        return len(self.features)

    @property
    def shapes(self):
        return {"input": (self.features.shape[1],),
                "target": (int(self.targets.max()) + 1,)}

    def _aux(self, idx, x):
        at = self.additional_target
        if at == "input":
            return x
        if at == "equiv_x":
            if self.positives is None:
                raise ValueError("equiv_x needs `positives`")
            return self.positives[idx]
        return self.targets[idx]

    def batches(self, batch_size: int, n_epochs: int = 1, seed: int = 0,
                shuffle: bool = True, drop_last: bool = True):
        rng = np.random.default_rng(seed)
        n = len(self)
        for _ in range(n_epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            stop = n - batch_size + 1 if drop_last else n
            for i in range(0, stop, batch_size):
                idx = order[i:i + batch_size]
                x = self.features[idx]
                yield x, self.targets[idx], self._aux(idx, x)

    @classmethod
    def load(cls, path: str | Path, **kwargs) -> "FeaturesDataset":
        """Load from .npz with keys features/targets[/positives]."""
        data = np.load(path)
        return cls(features=data["features"], targets=data["targets"],
                   positives=data.get("positives"), **kwargs)

    def save(self, path: str | Path):
        arrays = dict(features=self.features, targets=self.targets)
        if self.positives is not None:
            arrays["positives"] = self.positives
        np.savez(path, **arrays)
