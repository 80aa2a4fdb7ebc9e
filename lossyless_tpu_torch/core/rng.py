"""Host-side RNG helpers.

Counterpart of `lossyless_tpu/core/rng.py`: `tmp_seed`, a context that
seeds numpy's global RNG for deterministic host-side data making and
restores the previous state after. Device-side randomness takes explicit
`torch.Generator`s throughout and never needs it.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def tmp_seed(seed: int | None):
    """Seed numpy's global RNG with `seed` inside the block, then restore
    the state it had before; `None` leaves it untouched."""
    if seed is None:
        yield
        return
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
