"""Host decode helpers for the preprocess path.

The port's own copy of the helpers of `lossyless_tpu/data/loader.py` that
`nn.vit.pil_clip_preprocess` uses: an ordered thread-pool map over one
batch (PIL releases the GIL in decode and resize) and the opt-in libjpeg
scaled decode switch.

Knobs (env): `LOSSYLESS_LOADER_WORKERS` (default: min(16, cpus), 0/1 =
serial) and `LOSSYLESS_JPEG_DRAFT` (default 0).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

# one pool per worker count, never shut down mid-process: shutting down the
# old pool when the knob changes would race a still-live user of it into
# "cannot schedule new futures after shutdown". Knob flips are a bench/test
# pattern, so at most a handful of pools exist; idle threads cost nothing
# and join at exit.
_POOLS: dict[int, ThreadPoolExecutor] = {}
_POOL_LOCK = threading.Lock()


def n_workers() -> int:
    """Decode workers: env override, else min(16, cpu_count) like the
    reference's num_workers=16 default capped to the actual host."""
    env = os.environ.get("LOSSYLESS_LOADER_WORKERS")
    if env is not None:
        return max(0, int(env))
    return min(16, os.cpu_count() or 1)


def jpeg_draft_enabled() -> bool:
    """Opt-in libjpeg scaled decode for sources larger than the target.

    Falsy spellings in any case ('0', '', 'false', 'no', 'off') disable —
    a user exporting a Python bool ('False') must not silently get
    different pixels than the full-resolution path they asked for.
    """
    v = os.environ.get("LOSSYLESS_JPEG_DRAFT", "0").strip().lower()
    return v not in ("0", "", "false", "no", "off")


def get_pool() -> ThreadPoolExecutor | None:
    """Shared decode pool for the current worker knob (lazy, cached).

    Returns None when workers <= 1: the serial path then runs inline with
    zero thread overhead (and keeps single-core test runs deterministic in
    their scheduling).
    """
    w = n_workers()
    if w <= 1:
        return None
    with _POOL_LOCK:
        pool = _POOLS.get(w)
        if pool is None:
            pool = _POOLS[w] = ThreadPoolExecutor(
                w, thread_name_prefix=f"lossyless-io-{w}")
        return pool


def decode_map(fn: Callable, items: Sequence) -> list:
    """Ordered parallel map over one batch (identity to [fn(i) for i])."""
    pool = get_pool()
    if pool is None or len(items) <= 1:
        return [fn(it) for it in items]
    return list(pool.map(fn, items))
