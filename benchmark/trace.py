"""A bounded slice of a run under torch.profiler, reduced to what the
per-layer metrics and the result's `breakdown` read.

The slice is one `record_function("bench.slice")` range that ends in a
`torch.cuda.synchronize()`; its extent in the trace is the traced window.
Device operations are the trace's kernels, copies and sets. A kernel is
tied to the host call that launched it by the trace's correlation id, and
through that call to the host ranges around it (`record_function` ranges
and aten operators).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Event:
    name: str
    start: float        # microseconds, the trace's clock
    dur: float
    tid: object = None
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Slice:
    """The reduced trace of one slice, with the harness's own timings made
    while it ran (`spans`: name -> list of seconds)."""

    start: float
    end: float
    device: list
    host: list
    spans: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def kernels(self) -> list:
        """The device operations that are kernels (copies and sets carry no
        correlation id here)."""
        return [e for e in self.device if e.corr is not None]

    def busy_intervals(self, events=None) -> list:
        """The union of the events' intervals, clipped to the slice."""
        iv = sorted((max(e.start, self.start), min(e.end, self.end))
                    for e in (self.device if events is None else events))
        out = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, events=None) -> float:
        return sum(b - a for a, b in self.busy_intervals(events)) * 1e-6

    def device_s(self, events) -> float:
        """Summed device time of the events (inside the slice)."""
        return sum(max(0.0, min(e.end, self.end) - max(e.start, self.start))
                   for e in events) * 1e-6

    def matching(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [e for e in self.kernels if rx.search(e.name)]

    def launched_under(self, pattern: str) -> list:
        """Kernels whose launching call lies inside a host range whose name
        matches `pattern`, on the same thread."""
        rx = re.compile(pattern)
        spans = {}
        for h in self.host:
            if rx.search(h.name):
                spans.setdefault(h.tid, []).append((h.start, h.end))
        union = {}
        for tid, iv in spans.items():
            merged = []
            for a, b in sorted(iv):
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            union[tid] = merged
        launch = {h.corr: h for h in self.host if h.corr is not None}
        out = []
        for k in self.kernels:
            h = launch.get(k.corr)
            iv = union.get(h.tid) if h is not None else None
            if not iv:
                continue
            i = bisect.bisect_right(iv, [h.start, float("inf")]) - 1
            if i >= 0 and iv[i][0] <= h.start <= iv[i][1]:
                out.append(k)
        return out

    def host_s(self, name: str) -> float:
        """Summed host time of the ranges called `name` (outermost only)."""
        evs = sorted((h for h in self.host if h.name == name),
                     key=lambda h: (h.tid, h.start))
        total, last = 0.0, {}
        for h in evs:
            if h.start >= last.get(h.tid, -1.0):
                total += h.dur
                last[h.tid] = h.end
        return total * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + self.device_s([e])
        return [[_short(k), v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The `n` longest stretches with no device operation, each named
        by the innermost host range running at its middle."""
        busy = self.busy_intervals()
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            inner = [h for h in self.host if h.start <= mid <= h.end
                     and h.name != SLICE]
            name = min(inner, key=lambda h: h.dur).name if inner \
                else "host: outside any traced call"
            out.append([_short(name), (b - a) * 1e-6])
        return out


def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name[:160]


def reduce(trace: dict) -> Slice:
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    marks = [e for e in events if e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"no {SLICE} range in the trace")
    m = marks[0]
    start, end = float(m["ts"]), float(m["ts"]) + float(m["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        ev = Event(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                   (e.get("pid"), e.get("tid")), corr)
        if cat in DEVICE_CATS:
            if ev.end > start and ev.start < end:
                if cat != "kernel":
                    ev.corr = None
                device.append(ev)
        elif cat in HOST_CATS:
            if ev.end > start and ev.start < end:
                if cat not in ("cuda_runtime", "cuda_driver"):
                    ev.corr = None
                host.append(ev)
    return Slice(start, end, device, host)


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the block as the slice; afterwards `holder["slice"]` is its
    reduced trace. The trace file goes to a temporary directory under
    TMPDIR and is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as d:
        path = os.path.join(d, "trace.json")
        with profile(activities=acts) as prof:
            with record_function(SLICE):
                yield
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["slice"] = reduce(json.load(f))
