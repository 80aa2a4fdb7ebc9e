"""Networks and the hand-written CUDA kernels they run on."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "get_architecture": ".registry", "VisionTransformer": ".vit",
    "clip_preprocess": ".vit", "convert_openai_clip_weights": ".vit",
    "vit_b32": ".vit", "TextTransformer": ".clip_text",
    "convert_openai_clip_text_weights": ".clip_text",
    "convert_torchvision_resnet": ".convert_resnet",
    "ClipResNet": ".clip_resnet", "convert_clip_resnet": ".clip_resnet"})
