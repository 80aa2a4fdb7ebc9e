"""Per-dataset normalization tables.

Counterpart of `lossyless_tpu/data/norms.py`: the means and standard
deviations of each dataset's channels, and `normalize` / `unnormalize`
of NHWC numpy arrays with them. The image datasets read these tables
(`data/images.py`).
"""

from __future__ import annotations

import numpy as np

MEANS = {
    "mnist": [0.1307],
    "cifar10": [0.4914, 0.4822, 0.4465],
    "cifar100": [0.5071, 0.4865, 0.4409],
    "stl10": [0.43, 0.42, 0.39],
    "stl10_unlabeled": [0.43, 0.42, 0.39],
    "imagenet": [0.485, 0.456, 0.406],
    "clip": [0.48145466, 0.4578275, 0.40821073],
    "galaxy": [0.03294565, 0.04387402, 0.04995899],
}
STDS = {
    "mnist": [0.3081],
    "cifar10": [0.2470, 0.2435, 0.2616],
    "cifar100": [0.2673, 0.2564, 0.2762],
    "stl10": [0.27, 0.26, 0.27],
    "stl10_unlabeled": [0.27, 0.26, 0.27],
    "imagenet": [0.229, 0.224, 0.225],
    "clip": [0.26862954, 0.26130258, 0.27577711],
    "galaxy": [0.07004886, 0.07964786, 0.09574898],
}


def normalize(x: np.ndarray, dataset: str) -> np.ndarray:
    mean = np.asarray(MEANS[dataset], np.float32)
    std = np.asarray(STDS[dataset], np.float32)
    return (x - mean) / std


def unnormalize(x: np.ndarray, dataset: str) -> np.ndarray:
    mean = np.asarray(MEANS[dataset], np.float32)
    std = np.asarray(STDS[dataset], np.float32)
    return x * std + mean
