"""Host decode helpers for the preprocess path.

The port's own copy of the helpers of `lossyless_tpu/data/loader.py` that
`nn.vit.pil_clip_preprocess`, the CLI and the bench use: an ordered
thread-pool map over one batch (PIL releases the GIL in decode and
resize), the batch decode of image files, the opt-in libjpeg scaled decode
switch, and `prefetch`, which runs a generator a few items ahead on a
daemon thread so host decode overlaps the card's work.

Knobs (env): `LOSSYLESS_LOADER_WORKERS` (default: min(16, cpus), 0/1 =
serial), `LOSSYLESS_PREFETCH_DEPTH` (default 2, 0 = inline) and
`LOSSYLESS_JPEG_DRAFT` (default 0). Batches are the same bytes at any
worker count and prefetch depth.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

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


def decode_image_batch(paths: Sequence, size: tuple[int, int],
                       draft: bool | None = None) -> np.ndarray:
    """Decode and resize image files to a (B, H, W, 3) uint8 array: RGB,
    BICUBIC resize where the size differs, each worker writing its own
    rows. `draft` (default: `jpeg_draft_enabled()`) asks libjpeg for the
    smallest DCT scale still >= the target first."""
    from PIL import Image

    h, w = size
    out = np.empty((len(paths), h, w, 3), np.uint8)
    draft = jpeg_draft_enabled() if draft is None else draft

    def _one(i_p):
        i, p = i_p
        img = Image.open(p)
        if draft and img.format == "JPEG" and \
                (img.size[0] > w or img.size[1] > h):
            img.draft("RGB", (w, h))
        img = img.convert("RGB")
        if img.size != (w, h):
            img = img.resize((w, h), Image.BICUBIC)
        out[i] = np.asarray(img, np.uint8)

    decode_map(_one, list(enumerate(paths)))
    return out


def prefetch_depth() -> int:
    env = os.environ.get("LOSSYLESS_PREFETCH_DEPTH")
    return max(0, int(env)) if env is not None else 2


class _Raised:
    """Exception carrier across the prefetch queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def prefetch(gen: Iterable, depth: int | None = None) -> Iterator:
    """Yield from `gen`, produced on a daemon thread `depth` items ahead.

    Order-preserving; whatever `gen` raises is re-raised at the consumer's
    next pull. Closing the returned generator stops the producer: its
    queue puts poll a stop flag rather than block.
    """
    if depth is None:
        depth = prefetch_depth()
    if depth <= 0:
        yield from gen
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work():
        try:
            for item in gen:
                if not _put(item):
                    return
            _put(_DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            _put(_Raised(e))

    thread = threading.Thread(target=_work, daemon=True,
                              name="lossyless-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()
        # unblock a producer waiting on a full queue, then let it finish
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5.0)
