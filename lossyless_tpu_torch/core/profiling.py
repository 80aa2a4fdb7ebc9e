"""Profiling and debug instrumentation.

Counterpart of `lossyless_tpu/core/profiling.py`: `profile_trace` (a
`torch.profiler` trace, exported as a Chrome trace, where JAX writes a
`jax.profiler` trace), `device_memory_stats` (JAX's keys a device, from
the CUDA caching allocator) and `debug_mode` (autograd's anomaly
detection, where JAX turns on `jax_debug_nans`: the backward raises at
the op that made a NaN).

`span(name)` marks a stretch of the program in whatever profiler is
running (`profile_trace`, the CLI's `--profile-dir`, the benchmark's
slice): a `record_function` range, in the same trace and on the same
clock as the kernels it launches. With no profiler running it is one
shared no-op context. The names the program uses are fixed strings
(README, "Profiling"): readers match them exactly.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`with span("encode.dispatch"): ...`: a `record_function` range while
    a profiler runs on this thread, else a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None):
    """Trace the block with torch.profiler into `log_dir/trace.json`
    (Chrome's trace format; open in Perfetto or chrome://tracing): CUDA
    activity when a card is present, CPU activity always. `None` traces
    nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.fspath(log_dir / TRACE_FILE))


def device_memory_stats() -> dict:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}} of every
    visible card; `{}` without one."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


@contextlib.contextmanager
def debug_mode(enable: bool = True):
    """Autograd's anomaly detection inside the block (restored on exit):
    a backward that makes a NaN raises, naming the forward op."""
    if not enable:
        yield
        return
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)
