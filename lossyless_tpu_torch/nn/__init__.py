"""Networks and the hand-written CUDA kernels they run on."""

from .clip_resnet import ClipResNet, convert_clip_resnet
from .clip_text import TextTransformer, convert_openai_clip_text_weights
from .convert_resnet import convert_torchvision_resnet
from .registry import get_architecture
from .vit import (VisionTransformer, clip_preprocess,
                  convert_openai_clip_weights, vit_b32)

__all__ = ["get_architecture", "VisionTransformer", "clip_preprocess",
           "convert_openai_clip_weights", "vit_b32", "TextTransformer",
           "convert_openai_clip_text_weights", "convert_torchvision_resnet",
           "ClipResNet", "convert_clip_resnet"]
