"""torch.hub entry points of the PyTorch/CUDA port.

Counterpart of the root `hubconf.py`: each entry point returns a
`(compressor, transform)` pair. `transform` takes an iterable of PIL
images or HWC uint8 arrays of any size and returns the CLIP-normalized
NHWC float32 batch that `compressor` reads (`nn.vit.pil_clip_preprocess`).

    import torch
    compressor, transform = torch.hub.load(
        "<repo>/lossyless_tpu_torch", "clip_compressor_b005", source="local")
    streams = compressor.compress(transform([pil_image]))

The rate weights are the published `beta*_factorized_rate.pt` files
(`hub/load_reference.py`); without them the entry points raise
`FileNotFoundError`. Pass `clip_state_dict=` for real CLIP tower weights
and `device=` for another device than the card.
"""

from __future__ import annotations

dependencies = ["torch", "numpy"]


def _load(beta: str, pretrained: bool, **kwargs):
    from lossyless_tpu_torch.hub.compressor import load_pretrained
    from lossyless_tpu_torch.nn.vit import pil_clip_preprocess

    if not pretrained:
        raise ValueError(
            "pretrained=False is not a published configuration; the hub "
            "models ship trained rate weights (reference hubconf.py:22-52)")
    return load_pretrained(beta, **kwargs), pil_clip_preprocess


def clip_compressor_b001(pretrained: bool = True, **kwargs):
    """CLIP compressor, beta=0.01 (highest rate / lowest distortion):
    `(compressor, transform)`."""
    return _load("b001", pretrained, **kwargs)


def clip_compressor_b005(pretrained: bool = True, **kwargs):
    """CLIP compressor, beta=0.05, the headline ~1.5 kbit/img model:
    `(compressor, transform)`."""
    return _load("b005", pretrained, **kwargs)


def clip_compressor_b01(pretrained: bool = True, **kwargs):
    """CLIP compressor, beta=0.1 (lowest rate): `(compressor,
    transform)`."""
    return _load("b01", pretrained, **kwargs)
