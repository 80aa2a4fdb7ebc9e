"""Deployment hub API.

Named entry points mirror the reference's torch.hub interface:

    from lossyless_tpu_torch.hub import clip_compressor_b005
    compressor = clip_compressor_b005()

They need the published rate weights (`hub/load_reference.py`) and raise
`FileNotFoundError` without them.
"""

from __future__ import annotations

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "ClipCompressor": ".compressor", "load_pretrained": ".compressor"})
__all__ += ["clip_compressor_b001", "clip_compressor_b005",
            "clip_compressor_b01"]


def clip_compressor_b001(**kwargs) -> ClipCompressor:
    """CLIP compressor, beta=0.01 (higher rate / lower distortion)."""
    from .compressor import load_pretrained
    return load_pretrained("b001", **kwargs)


def clip_compressor_b005(**kwargs) -> ClipCompressor:
    """CLIP compressor, beta=0.05 (the headline model: ~1.5 kbit/img)."""
    from .compressor import load_pretrained
    return load_pretrained("b005", **kwargs)


def clip_compressor_b01(**kwargs) -> ClipCompressor:
    """CLIP compressor, beta=0.1 (lowest rate)."""
    from .compressor import load_pretrained
    return load_pretrained("b01", **kwargs)
