"""CLIP ViT-B/32 visual tower in PyTorch.

Counterpart of `lossyless_tpu/nn/vit.py`, with the same arithmetic:

* the compute dtype (bf16 by default) for activations and matmuls, with
  every LayerNorm computed in fp32 (eps 1e-5, OpenAI CLIP's) and cast back;
  `ln_dtype` (JAX's knob, fp32 by default) rounds the output of `ln_pre`
  and of each block's LayerNorms to that dtype first, as flax's
  `LayerNorm(dtype=ln_dtype)` does: flax keeps the statistics and the
  normalization in fp32 and rounds only its output, so in a bf16 tower
  `ln_dtype=bfloat16` changes nothing; `ln_post` stays fp32;
* `remat=True` recomputes each block in the backward
  (`torch.utils.checkpoint`, JAX's `nn.remat`): the attention and K4
  kernels then launch twice a training forward;
* patchify as one block-reshape + matmul against the HWIO kernel;
* pre-LN blocks with QuickGELU (x * sigmoid(1.702x));
* final LayerNorm on the class token (fp32) + projection to 512-d;
* the last block computes only the class token's row (`cls_only_last`).

Parameters keep the flax layout — Dense `kernel (in, out)`, LayerNorm
`scale`/`bias`, the patchify kernel HWIO — so `params_from_flax` is a
renaming and the parity tests compare like with like. Dense layers compute
`x @ kernel + bias` in the compute dtype: a bf16 matmul rounds, then the
bias add rounds again, as flax's Dense does.

Attention runs on the hand-written kernels of `nn/flash_attn.py`
(`attn_impl="kernel"`, the default; on CPU tensors they take their plain
version) or on the plain versions directly (`attn_impl="plain"`). The MLP
half-blocks run as torch ops (`mlp_impl="ops"`, the default) or on the
fused kernel K4 (`mlp_impl="kernel"`).

`convert_openai_clip_weights` maps an OpenAI CLIP state dict onto this
module's state dict. Images are NHWC at the public functions, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .flash_attn import (attention_cls_plain, attention_plain,
                         fused_attention, fused_attention_cls,
                         fused_mlp_block)

LN_EPS = 1e-5


class Dense(nn.Module):
    """flax `nn.Dense` layout: `kernel (in, out)`, `bias (out,)`."""

    def __init__(self, features_in: int, features_out: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with flax's `scale`/`bias` names, computed in fp32; the
    output rounded to `dtype` (flax's `LayerNorm(dtype=...)`)."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                            self.bias.float(), LN_EPS).to(self.dtype)


class MHSA(nn.Module):
    """Multi-head self-attention off one fused qkv projection.

    With `cls_only` the queries are the class token's alone: the q
    projection is a column slice of the same qkv kernel, so the parameters
    (and converted CLIP weights) are unchanged, and the output is (B, 1, D).
    """

    def __init__(self, width: int, heads: int, dtype, attn_impl: str,
                 cls_only: bool = False):
        super().__init__()
        if attn_impl not in ("kernel", "plain"):
            raise ValueError(f"unknown attn_impl={attn_impl!r}")
        self.width, self.heads, self.dtype = width, heads, dtype
        self.attn_impl, self.cls_only = attn_impl, cls_only
        self.qkv = Dense(width, 3 * width, dtype)
        self.proj = Dense(width, width, dtype)

    def forward(self, x):
        D, h = self.width, self.heads
        kernel = self.attn_impl == "kernel"
        if self.cls_only:
            w = self.qkv.kernel.to(self.dtype)
            b = self.qkv.bias.to(self.dtype)
            q0 = x[:, :1] @ w[:, :D] + b[:D]
            kv = x @ w[:, D:] + b[D:]
            out = (fused_attention_cls(q0, kv, h) if kernel
                   else attention_cls_plain(q0, kv, h))
        else:
            qkv = self.qkv(x)
            out = (fused_attention(qkv, h) if kernel
                   else attention_plain(qkv, h))
        return self.proj(out)


class PatchEmbed(nn.Module):
    """Patchify as block-reshape + one matmul against the HWIO kernel."""

    def __init__(self, width: int, patch: int, dtype, channels: int = 3):
        super().__init__()
        self.width, self.patch, self.dtype = width, patch, dtype
        self.kernel = nn.Parameter(torch.empty(patch, patch, channels, width))

    def forward(self, x):
        B, H, W, C = x.shape
        p = self.patch
        gh, gw = H // p, W // p
        # (B, gh, p, gw, p, C) -> (B, gh*gw, p*p*C); the (p, p, C) flatten
        # order matches the HWIO kernel flatten below
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, p * p * C)
        return x @ self.kernel.to(self.dtype).reshape(p * p * C, self.width)


def quick_gelu(y):
    return y * torch.sigmoid(1.702 * y)


class Block(nn.Module):
    """Pre-LN transformer block; `cls_only` computes the class token only
    (valid as the last block, when downstream reads x[:, 0] alone).

    `mlp_impl="kernel"` runs the MLP half-block (LN2, fc, QuickGELU, proj,
    residual) as the hand-written kernel K4 (`fused_mlp_block`); `"ops"`
    (the default) as torch ops. A cls-only block keeps the ops path, as in
    JAX. The parameters are the same either way.
    """

    def __init__(self, width: int, heads: int, dtype, attn_impl: str,
                 cls_only: bool = False, mlp_impl: str = "ops",
                 ln_dtype=torch.float32):
        super().__init__()
        if mlp_impl not in ("ops", "kernel"):
            raise ValueError(f"unknown mlp_impl={mlp_impl!r}")
        self.dtype, self.cls_only = dtype, cls_only
        self.mlp_impl = mlp_impl
        self.ln_1 = LayerNorm(width, ln_dtype)
        self.attn = MHSA(width, heads, dtype, attn_impl, cls_only)
        self.ln_2 = LayerNorm(width, ln_dtype)
        self.mlp_fc = Dense(width, 4 * width, dtype)
        self.mlp_proj = Dense(4 * width, width, dtype)

    def forward(self, x):
        y = self.ln_1(x).to(self.dtype)
        # the residual stream narrows to the class token in a cls-only block
        x = (x[:, :1] if self.cls_only else x) + self.attn(y)
        if self.mlp_impl == "kernel" and not self.cls_only:
            return fused_mlp_block(
                x, self.ln_2.scale, self.ln_2.bias, self.mlp_fc.kernel,
                self.mlp_fc.bias, self.mlp_proj.kernel, self.mlp_proj.bias,
                LN_EPS)
        y = self.ln_2(x).to(self.dtype)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(y)))


class VisionTransformer(nn.Module):
    """CLIP visual tower. Input NHWC float images (already normalized)."""

    def __init__(self, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, out_dim: int = 512,
                 image_size: int = 224, dtype=torch.bfloat16,
                 attn_impl: str = "kernel", cls_only_last: bool = True,
                 mlp_impl: str = "ops", ln_dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.patch_size, self.width, self.image_size = patch_size, width, \
            image_size
        self.dtype, self.remat = dtype, remat
        self.n_tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(width, patch_size, dtype)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(self.n_tokens, width))
        self.ln_pre = LayerNorm(width, ln_dtype)
        self.blocks = nn.ModuleList(
            Block(width, heads, dtype, attn_impl,
                  cls_only=cls_only_last and i == layers - 1,
                  mlp_impl=mlp_impl, ln_dtype=ln_dtype)
            for i in range(layers))
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, out_dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's initializers, drawn from `generator`:
        LeCun truncated normal for the kernels, N(0, 0.02) for the
        embeddings and projection, LayerNorm ones/zeros, zero biases."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                fan_in = math.prod(p.shape[:-1])
                # flax truncated_normal: [-2, 2] std, rescaled to unit var
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name in ("class_embedding", "positional_embedding", "proj"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, x):
        B = x.shape[0]
        x = self.patch_embed(x.to(self.dtype))
        if x.shape[1] + 1 != self.n_tokens:
            raise ValueError(
                f"input gives {x.shape[1]} patches but image_size="
                f"{self.image_size} expects {self.n_tokens - 1}; construct "
                f"the tower with image_size matching the data resolution")
        cls = self.class_embedding.to(self.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) \
            + self.positional_embedding.to(self.dtype)[None]
        x = self.ln_pre(x).to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat \
                else block(x)
        x = self.ln_post(x[:, 0])
        return (x.to(self.dtype) @ self.proj.to(self.dtype)).float()


def vit_b32(dtype=torch.bfloat16, **kwargs) -> VisionTransformer:
    return VisionTransformer(dtype=dtype, **kwargs)


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

# CLIP preprocessing constants (clip.load's transform: bicubic resize 224 +
# center crop + per-channel normalize)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _keys_cubic(x):
    """Keys cubic kernel with a = -0.5 (the JAX "cubic" resize kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weight_mat(in_size: int, out_size: int, device=None):
    """(in_size, out_size) fp32 resampling matrix of one axis.

    The same matrix `jax.image.resize(..., "cubic")` builds: half-pixel
    sample centres, the kernel widened by 1/scale when downsampling
    (antialias), columns renormalized to sum 1, and samples outside
    [-0.5, in - 0.5] zeroed.
    """
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.0 - 0.5
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32, device=device)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def clip_preprocess(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Resize (bicubic) + center-crop + normalize; NHWC in [0, 1].

    Not `F.interpolate(mode="bicubic")`, which uses a = -0.75 with edge
    clamping and no antialias: the two resampling matrices of
    `cubic_weight_mat` applied as fp32 matmuls, so the result is JAX's
    `clip_preprocess` to float tolerance.
    """
    # the resampling matmuls must run in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, c = x.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = x.float()
    if nh != h:   # like jax.image.resize, leave an unchanged axis alone
        x = torch.einsum("bhwc,hH->bHwc", x,
                         cubic_weight_mat(h, nh, x.device))
    if nw != w:
        x = torch.einsum("bhwc,wW->bhWc", x,
                         cubic_weight_mat(w, nw, x.device))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size]
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def pil_clip_preprocess(images, size: int = 224,
                        draft: bool | None = None) -> np.ndarray:
    """Host-side CLIP preprocess, the reference transform verbatim.

    PIL bicubic resize of the short side to `size`, center crop, /255,
    CLIP-normalize — exactly `clip.load`'s `_transform`. Accepts an iterable
    of HWC uint8 arrays or PIL Images (mixed sizes fine); returns a
    (B, size, size, 3) float32 batch. `draft` (default:
    `data.loader.jpeg_draft_enabled()`) decodes JPEGs at a reduced DCT
    scale.
    """
    from PIL import Image

    from ..data.loader import decode_map, jpeg_draft_enabled

    draft = jpeg_draft_enabled() if draft is None else draft

    def _one(im):
        pil = im if isinstance(im, Image.Image) else Image.fromarray(im)
        if draft and pil.format == "JPEG":
            # opt-in libjpeg scaled decode (must be requested before pixel
            # access): PIL picks the largest DCT reduction keeping both
            # dims >= `size`, so the short side still reaches `size`
            pil.draft("RGB", (size, size))
        if pil.mode != "RGB":
            pil = pil.convert("RGB")
        w, h = pil.size
        scale = size / min(w, h)
        nw, nh = round(w * scale), round(h * scale)
        pil = pil.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        pil = pil.crop((left, top, left + size, top + size))
        arr = np.asarray(pil).astype(np.float32) / 255.0
        return (arr - CLIP_MEAN) / CLIP_STD

    # ordered thread-pool map: the batch is byte-identical to a serial loop
    images = images if isinstance(images, (list, tuple)) else list(images)
    return np.stack(decode_map(_one, images)).astype(np.float32)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def params_from_flax(tree) -> dict:
    """JAX `VisionTransformer` param tree (numpy arrays) -> state dict.

    The layouts are the same; only the names change (`block{i}` becomes
    `blocks.{i}`). Values come back as fp32 tensors.
    """
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if prefix == "" and k.startswith("block"):
                k = f"blocks.{int(k[len('block'):])}"
            name = f"{prefix}{k}"
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, name + ".")
            else:
                out[name] = torch.from_numpy(
                    np.array(v, dtype=np.float32, copy=True))

    walk(tree, "")
    return out


def convert_openai_clip_weights(torch_state_dict) -> dict:
    """Map OpenAI CLIP `visual.*` weights onto this module's state dict.

    Accepts the state dict of the full CLIP model or of the visual tower.
    Returns what the JAX package's converter followed by `params_from_flax`
    returns.
    """
    # A FULL CLIP state dict carries both towers; after stripping "visual."
    # the text tower's transformer.resblocks.* would collide with the
    # visual ones, so when any visual.* key exists keep ONLY that subtree.
    items = torch_state_dict.items()
    if any(k.startswith("visual.") for k in torch_state_dict):
        items = [(k[len("visual."):], v) for k, v in items
                 if k.startswith("visual.")]
    sd = {}
    for k, v in items:
        sd[k] = np.asarray(v.float().cpu().numpy() if hasattr(v, "cpu") else v,
                           dtype=np.float32)

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    params = {
        # torch conv OIHW -> HWIO
        "patch_embed": {"kernel": sd["conv1.weight"].transpose(2, 3, 1, 0)},
        "class_embedding": sd["class_embedding"],
        "positional_embedding": sd["positional_embedding"],
        "ln_pre": ln("ln_pre"),
        "ln_post": ln("ln_post"),
        "proj": sd["proj"],
    }
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        p = f"transformer.resblocks.{i}"
        params[f"block{i}"] = {
            "ln_1": ln(f"{p}.ln_1"),
            "ln_2": ln(f"{p}.ln_2"),
            "attn": {
                "qkv": {"kernel": sd[f"{p}.attn.in_proj_weight"].T,
                        "bias": sd[f"{p}.attn.in_proj_bias"]},
                "proj": {"kernel": sd[f"{p}.attn.out_proj.weight"].T,
                         "bias": sd[f"{p}.attn.out_proj.bias"]},
            },
            "mlp_fc": {"kernel": sd[f"{p}.mlp.c_fc.weight"].T,
                       "bias": sd[f"{p}.mlp.c_fc.bias"]},
            "mlp_proj": {"kernel": sd[f"{p}.mlp.c_proj.weight"].T,
                         "bias": sd[f"{p}.mlp.c_proj.bias"]},
        }
        i += 1
    return params_from_flax(params)
