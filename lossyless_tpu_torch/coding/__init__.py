"""Host coding layer: entropy bottleneck, rANS codec, dataset framing."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "entropy_bottleneck": ".entropy_bottleneck",
    "gaussian_conditional": ".gaussian_conditional",
    "read_dataset": ".bitstream", "write_dataset": ".bitstream",
    "RansCodec": ".rans", "pmf_to_quantized_cdf": ".rans"})
