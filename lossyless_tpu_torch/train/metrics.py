"""Metric aggregation and the results CSV sink.

Counterpart of `lossyless_tpu/train/metrics.py`: metric namespace
`{split}/{stage}/{metric}`, one-row `results_{stage}.csv` per stage under
the experiment directory, and the step-series `CsvLogger`. The files are
the JAX package's, byte for byte.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path

import numpy as np


def _as_float(v):
    """float(v) for a number or a one-element tensor/array, else None."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return None


class MetricAccumulator:
    """Running weighted mean of scalar logs over an epoch or eval pass;
    non-finite values are dropped."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def update(self, logs: dict, weight: int = 1):
        for k, v in logs.items():
            val = _as_float(v)
            if val is not None and np.isfinite(val):
                self._sums[k] += val * weight
                self._counts[k] += weight

    def means(self) -> dict:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}

    def reset(self):
        self._sums.clear()
        self._counts.clear()


def namespaced(logs: dict, split: str, stage: str) -> dict:
    return {f"{split}/{stage}/{k}": v for k, v in logs.items()}


def write_results_csv(out_dir, stage: str, metrics: dict) -> Path:
    """One-row CSV of `test/{stage}/...` metrics, columns sorted."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"results_{stage}.csv"
    keys = sorted(metrics)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(keys)
        w.writerow([metrics[k] for k in keys])
    return path


def read_results_csv(path) -> dict:
    with Path(path).open() as f:
        r = list(csv.reader(f))
    return {k: float(v) if _as_float(v) is not None else v
            for k, v in zip(r[0], r[1])}


class CsvLogger:
    """Step-series logger. Rows carrying new keys extend the header by
    rewriting the file once; an existing file's header is adopted on
    resume, so appended values stay under the right columns."""

    def __init__(self, out_dir, name: str = "metrics"):
        self.path = Path(out_dir) / f"{name}.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys: list[str] | None = None
        if self.path.exists():  # resume: adopt the existing header
            with self.path.open(newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._keys = header

    def log(self, step: int, logs: dict):
        row = {"step": step}
        row.update({k: _as_float(v) for k, v in logs.items()
                    if _as_float(v) is not None})
        if self._keys is None:
            self._keys = list(row)
            with self.path.open("w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._keys).writeheader()
        new_keys = [k for k in row if k not in self._keys]
        if new_keys:
            self._rewrite_with_keys(self._keys + new_keys)
        with self.path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys,
                               restval="", extrasaction="ignore")
            w.writerow(row)

    def _rewrite_with_keys(self, keys: list[str]):
        """Extend the header in place (prior rows get empty cells)."""
        with self.path.open(newline="") as f:
            rows = list(csv.DictReader(f))
        self._keys = keys
        with self.path.open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, restval="")
            w.writeheader()
            w.writerows(rows)
