"""Wall-clock timers for the timing metrics.

Counterpart of `lossyless_tpu/core/timing.py`: `Timer` (the per-image
`encoder_time`, `compress_time`, ... metrics) and `device_timer`, which
synchronizes the device it times so that queued kernels are inside the
measurement. JAX's `pipelined_iqm` (a trimmed rate over in-flight
dispatches) has no counterpart: the port is timed by its benchmark
(`python3 -m benchmark.run`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Timer:
    """`with Timer() as t: ...; t.duration` (seconds)."""

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self._start
        return False


@contextmanager
def device_timer(result_holder: dict, key: str, device=None):
    """Time a block that ends with device work into `result_holder[key]`
    (seconds), synchronizing `device` (default: the current CUDA device
    when a card is present) before the clock stops."""
    start = time.perf_counter()
    try:
        yield
    finally:
        device = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        result_holder[key] = time.perf_counter() - start
