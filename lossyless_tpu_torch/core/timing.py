"""Wall-clock timers for the timing metrics.

Counterpart of `lossyless_tpu/core/timing.py`: `Timer` (the per-image
`encoder_time`, `compress_time`, ... metrics), `pipelined_iqm` (the
microbenchmarks' trimmed rate over a pipeline of in-flight dispatches)
and `device_timer`, which synchronizes the device it times so that queued
kernels are inside the measurement. A result is waited on through a CUDA
event recorded after its dispatch, never through a copy to the host.
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


def _devices(result) -> set:
    """The CUDA devices the tensors of `result` (a tensor or a nest of
    lists, tuples and dicts of them) lie on."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*map(_devices, result))
    return set()


def _mark(result) -> list:
    """One CUDA event a device of `result`, recorded now on that device's
    current stream: waiting on them waits for the work queued so far."""
    events = []
    for device in _devices(result):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        events.append(ev)
    return events


def pipelined_iqm(dispatch, reps: int = 12, depth: int = 2):
    """Time `dispatch(r)` (asynchronous device work) with `depth` results
    in flight.

    Keeps `depth` dispatches queued so the host never leaves a bubble
    between device windows, then reports the interquartile mean of the
    gaps between completions: robust to a transient stall (which blows up
    the mean) and to completions bunching under the pipeline (which makes
    the median and the minimum optimistic). `dispatch` returns tensors
    (or a nest of them) and should vary its input with `r`. Returns
    (iqm_seconds, min_seconds)."""
    marks = [time.perf_counter()]
    inflight = []
    for r in range(min(depth, reps)):
        inflight.append(_mark(dispatch(r)))
    for r in range(reps):
        for ev in inflight.pop(0):
            ev.synchronize()
        nxt = r + depth
        if nxt < reps:
            inflight.append(_mark(dispatch(nxt)))
        marks.append(time.perf_counter())
    gaps = sorted(b - a for a, b in zip(marks, marks[1:]))
    q = len(gaps) // 4
    mid = gaps[q:len(gaps) - q] or gaps
    return sum(mid) / len(mid), min(gaps)


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
