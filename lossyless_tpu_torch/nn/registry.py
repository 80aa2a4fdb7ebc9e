"""Architecture registry.

Counterpart of `lossyless_tpu/nn/registry.py`: maps a mode string + kwargs
to a module taking (in_shape, out_shape). Image shapes are channels-last
(H, W, C). Ported: the CLIP ViT tower, the `mlp`, `linear` and
`identity` heads (`nn/mlp.py`), the `cnn` and `balle` encoders and, for
an int `in_shape` and an image `out_shape`, their transposed decoders
(`nn/cnn.py`), the `resnet` (`nn/resnet.py`), and the pretrained towers:
`clip_rn50`, CLIP's ModifiedResNet-50 with K2 as its attention pool
(`nn/clip_resnet.py`), and `simclr` / `swav`, a torchvision ResNet-50
(`nn/resnet.py` at `base="resnet50"`), whose public weights load through
`encoder.pretrained_path` (`nn/pretrained.py`).
`generator` seeds the init (torch needs it at construction; the tower
takes it through `init_weights`).

The JAX config vocabulary is translated, so a JAX preset or override
string works unchanged: `mlp_impl` "pallas" -> "kernel", "xla" -> "ops";
`attn_impl` "pallas"/"auto" -> "kernel", "einsum" -> "plain"; a dtype
given by name ("bfloat16", "float32") becomes the torch dtype.
"""

from __future__ import annotations

import torch

from .clip_resnet import ClipResNet
from .cnn import BalleDecoder, BalleEncoder, CNNDecoder, CNNEncoder
from .mlp import FlattenLinear, FlattenMLP, Identity
from .resnet import ResNet
from .vit import VisionTransformer

_MLP_IMPL = {"pallas": "kernel", "xla": "ops", "kernel": "kernel",
             "ops": "ops"}
_ATTN_IMPL = {"pallas": "kernel", "auto": "kernel", "einsum": "plain",
              "kernel": "kernel", "plain": "plain"}
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def _translate(kwargs: dict) -> dict:
    kwargs = dict(kwargs)
    if "mlp_impl" in kwargs:
        kwargs["mlp_impl"] = _MLP_IMPL[kwargs["mlp_impl"]]
    if "attn_impl" in kwargs:
        kwargs["attn_impl"] = _ATTN_IMPL[kwargs["attn_impl"]]
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = _DTYPES[kwargs["dtype"]]
    return kwargs


def get_architecture(mode: str, in_shape, out_shape, generator=None,
                     **kwargs):
    """Instantiate an architecture module.

    `in_shape`: int or tuple (H, W, C); `out_shape`: int or tuple.
    """
    if mode == "mlp":
        return FlattenMLP(in_shape, out_shape, generator=generator, **kwargs)
    if mode == "linear":
        return FlattenLinear(in_shape, out_shape, generator=generator,
                             **kwargs)
    if mode == "identity":
        return Identity()
    if mode in ("clip", "clip_vit"):
        # the requested output dim and the dataset's resolution: the tower
        # patchifies at any square size (pos-embedding sized accordingly)
        if isinstance(in_shape, int) or not isinstance(out_shape, int):
            raise ValueError("clip tower is an encoder (image -> vector)")
        h, w, _ = in_shape
        if h != w:
            raise ValueError(f"clip tower needs square inputs, got {h}x{w}")
        kwargs = _translate(kwargs)
        kwargs.setdefault("image_size", h)
        # flax's default compute dtype for the tower is bf16
        kwargs.setdefault("dtype", torch.bfloat16)
        return VisionTransformer(out_dim=out_shape, **kwargs)
    if mode in ("cnn", "balle"):
        kwargs = _translate(kwargs)
        enc, dec = (CNNEncoder, CNNDecoder) if mode == "cnn" \
            else (BalleEncoder, BalleDecoder)
        if isinstance(in_shape, int) and not isinstance(out_shape, int):
            return dec(in_shape, tuple(out_shape), generator=generator,
                       **kwargs)
        return enc(out_shape, tuple(in_shape), generator=generator,
                   **kwargs)
    if mode == "resnet":
        return ResNet(out_shape, tuple(in_shape), generator=generator,
                      **_translate(kwargs))
    if mode == "clip_rn50":
        # OpenAI CLIP's ModifiedResNet-50 (the reference keeps
        # clip.load("RN50").visual): the pool's positional embedding is
        # sized from the input resolution
        return ClipResNet(out_shape, tuple(in_shape), generator=generator,
                          **_translate(kwargs))
    if mode in ("simclr", "swav"):
        # the SSL towers: a torchvision ResNet-50 backbone
        return ResNet(out_shape, tuple(in_shape), base="resnet50",
                      generator=generator, **_translate(kwargs))
    raise ValueError(f"unknown architecture mode={mode}")
