"""The program's own spans in a traced slice.

The port marks its stretches with `core.profiling.span` (README,
"Profiling"): `record_function` ranges in the slice's trace, which
`trace.reduce` keeps among the host events. A span is matched by its
exact name. A reader counts a span against what the harness says the
slice held (`slice_batches`, `slice_steps`): no such span at all is a
program that has none (the reader returns None), any other count a
renamed or misplaced span, which is an error.

`launched_in` ties a kernel to a span on any thread: the backward's
kernels are launched from autograd's device thread while the step's
`train.backward` is open on the calling thread.
"""

from __future__ import annotations

import bisect


def named(s, name: str) -> list:
    """The host ranges of the slice called `name`, by start."""
    return sorted((h for h in s.host if h.name == name),
                  key=lambda h: h.start)


def counted(s, name: str, n: int) -> list | None:
    """The spans called `name`, which must number `n`; None where the
    slice has none."""
    found = named(s, name)
    if not found:
        return None
    if len(found) != n:
        raise RuntimeError(f"{len(found)} {name} spans in a slice of {n}")
    return found


def ms(events) -> float:
    """The spans' summed host time in milliseconds."""
    return 1e-3 * sum(e.dur for e in events)


def launched_in(s, names) -> list:
    """Kernels whose launching call starts inside a span called one of
    `names`, on any thread."""
    merged = []
    for a, b in sorted((h.start, h.end) for h in s.host if h.name in names):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    launch = {h.corr: h.start for h in s.host if h.corr is not None}
    out = []
    for k in s.kernels:
        t = launch.get(k.corr)
        if t is None:
            continue
        i = bisect.bisect_right(merged, [t, float("inf")]) - 1
        if i >= 0 and merged[i][0] <= t <= merged[i][1]:
            out.append(k)
    return out


def step_device_ms(rec, name: str) -> float | None:
    """Device milliseconds a traced step of the kernels launched inside
    the span `name`, which the slice holds once a step."""
    s, steps = rec.slice, rec.info.get("slice_steps")
    if s is None or not steps or not s.kernels \
            or counted(s, name, steps) is None:
        return None
    return 1e3 * s.device_s(launched_in(s, {name})) / steps
