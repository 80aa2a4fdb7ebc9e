"""Pre-featurized datasets.

Counterpart of `lossyless_tpu/data/features.py` (`FeaturesDataset`):
feature arrays with their targets and, for `additional_target="equiv_x"`,
pre-featurized positives; `batches` yields `(x, target, aux)` in the JAX
order (one `default_rng(seed)` permutation an epoch), `device_sampler`
draws batches on the card for `train.state.make_generative_epoch`, and
`save` / `load` use the same `.npz` keys (`features`, `targets`,
`positives`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core import mesh
from ..core.device import resolve_device


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

    def device_sampler(self, batch_size: int, device=None):
        """`sample(generator) -> (x, y, aux)`: `batch_size` rows drawn
        uniformly with replacement by `torch.randint` on the generator,
        from the features, targets and positives staged once on `device`
        (default: the card); aux as `batches` makes it. In a data-parallel
        epoch every draw is the global batch's (`core.mesh.global_draw`)."""
        device = resolve_device(device)
        at = self.additional_target
        if at == "equiv_x" and self.positives is None:
            raise ValueError("equiv_x needs `positives`")
        feats = torch.as_tensor(self.features, device=device)
        targets = torch.as_tensor(self.targets, device=device)
        pos = None if self.positives is None \
            else torch.as_tensor(self.positives, device=device)
        n = len(self)

        def sample(generator: torch.Generator):
            idx = mesh.global_draw(lambda s: torch.randint(
                0, n, s, generator=generator, device=device), (batch_size,))
            x, y = feats[idx], targets[idx]
            if at == "input":
                aux = x
            elif at == "equiv_x":
                aux = pos[idx]
            else:
                aux = y
            return x, y, aux

        return sample

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
