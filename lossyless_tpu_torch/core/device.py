"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for another device.

    Never continues silently on the CPU: with no device given and no CUDA
    card visible this raises, so a run meant for the card cannot quietly
    measure the CPU instead.
    """
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        if device.index is None:   # pin the index: tensors report theirs
            device = torch.device("cuda", torch.cuda.current_device())
    return device
