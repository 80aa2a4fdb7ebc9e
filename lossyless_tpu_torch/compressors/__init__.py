"""Rate and distortion estimators, the learnable compressor and the
classical codec baselines."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "ClassicalCompressor": ".classical",
    "CompressorConfig": ".compressor", "EncoderConfig": ".compressor",
    "LearnableCompressor": ".compressor", "LossConfig": ".compressor",
    "OnlineEvalConfig": ".compressor",
    "DistortionConfig": ".distortions",
    "make_distortion_estimator": ".distortions",
    "FactorizedCoder": ".rates", "HyperpriorCoder": ".rates",
    "RateConfig": ".rates", "SpatialHyperpriorCoder": ".rates",
    "make_rate_estimator": ".rates"})
