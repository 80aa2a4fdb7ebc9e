"""Plain CLIP ViT-B/32 image encoder and CLIP preprocessing, in float32.

The tower follows OpenAI CLIP's `VisionTransformer` (clip/model.py):
patchify by a 32 x 32 stride-32 convolution without bias, the class token
and the learned positions, `ln_pre`, pre-LayerNorm residual blocks of
multi-head self-attention and a 4x MLP with QuickGELU (x * sigmoid(1.702
x)), `ln_post` of the class token and the projection to the output width.
LayerNorm eps 1e-5. The weights come in the layout the benchmark makes
them in (`weight_shapes`): dense kernels as (in, out), the patchify
kernel as (kh, kw, c_in, width), LayerNorm `scale` / `bias`.

The preprocessing is the hub's: resize of the short side to 224 by the
Keys cubic (a = -0.5) at half-pixel sample centres, the kernel widened by
the scale factor when shrinking and each output's weights renormalised to
sum 1 (`jax.image.resize(..., "cubic")`), a centre crop, then CLIP's mean
and std.

`precision="fp8"` rounds both inputs of every product (the patchify, the
projections, the attention's two products, the MLP, the head) to
float8 e4m3 with one scale a tensor, and computes the rest in float32: the
lower precision the control of the benchmark's comparison runs in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
E4M3_MAX = 448.0


def weight_shapes(width: int, layers: int, patch: int, image: int,
                  out_dim: int) -> dict:
    """Name -> shape of every weight of the tower."""
    n = (image // patch) ** 2 + 1
    shapes = {"patch_embed.kernel": (patch, patch, 3, width),
              "class_embedding": (width,),
              "positional_embedding": (n, width),
              "ln_pre.scale": (width,), "ln_pre.bias": (width,)}
    for i in range(layers):
        b = f"blocks.{i}."
        shapes.update({
            b + "ln_1.scale": (width,), b + "ln_1.bias": (width,),
            b + "attn.qkv.kernel": (width, 3 * width),
            b + "attn.qkv.bias": (3 * width,),
            b + "attn.proj.kernel": (width, width),
            b + "attn.proj.bias": (width,),
            b + "ln_2.scale": (width,), b + "ln_2.bias": (width,),
            b + "mlp_fc.kernel": (width, 4 * width),
            b + "mlp_fc.bias": (4 * width,),
            b + "mlp_proj.kernel": (4 * width, width),
            b + "mlp_proj.bias": (width,)})
    shapes.update({"ln_post.scale": (width,), "ln_post.bias": (width,),
                   "proj": (width, out_dim)})
    return shapes


def _keys(t: np.ndarray) -> np.ndarray:
    t = np.abs(t)
    near = (1.5 * t - 2.5) * t * t + 1.0
    far = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    return np.where(t < 1.0, near, np.where(t < 2.0, far, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of one axis of the cubic resize."""
    scale = n_out / n_in
    widen = max(1.0 / scale, 1.0)
    centre = (np.arange(n_out) + 0.5) / scale - 0.5
    w = _keys((np.arange(n_in)[:, None] - centre[None, :]) / widen)
    return (w / w.sum(0, keepdims=True)).astype(np.float32)


def preprocess(images_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32, normalised."""
    x = images_uint8.float() / 255.0
    _, h, w, _ = x.shape
    s = size / min(h, w)
    nh, nw = round(h * s), round(w * s)
    if nh != h:
        x = torch.einsum("bhwc,hk->bkwc", x, torch.from_numpy(
            resize_matrix(h, nh)).to(x.device))
    if nw != w:
        x = torch.einsum("bhwc,wk->bhkc", x, torch.from_numpy(
            resize_matrix(w, nw)).to(x.device))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size]
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (its largest magnitude to
    the format's largest), back in float32."""
    amax = t.abs().amax().clamp(min=1e-12)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


class Tower:
    """The image tower on float32 copies of `weights`."""

    def __init__(self, weights: dict, heads: int, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.w = {k: v.float() for k, v in weights.items()}
        self.heads = heads
        self.q = fp8 if precision == "fp8" else (lambda t: t)
        self.layers = sum(1 for k in self.w if k.endswith("mlp_fc.kernel"))

    def _mm(self, a, b):
        return self.q(a) @ self.q(b)

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".scale"],
                            self.w[name + ".bias"], 1e-5)

    def _dense(self, x, name):
        return self._mm(x, self.w[name + ".kernel"]) + self.w[name + ".bias"]

    def _attention(self, x, name):
        B, N, D = x.shape
        h = self.heads
        d = D // h
        qkv = self._dense(x, name + ".qkv")
        q, k, v = (t.reshape(B, N, h, d).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        att = torch.softmax(self._mm(q, k.transpose(-1, -2)) / math.sqrt(d),
                            dim=-1)
        out = self._mm(att, v).transpose(1, 2).reshape(B, N, D)
        return self._dense(out, name + ".proj")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 224, 224, 3) normalised images -> (B, out_dim) float32."""
        kernel = self.w["patch_embed.kernel"]
        p, D = kernel.shape[0], kernel.shape[-1]
        B, H, W, C = x.shape
        patches = x.reshape(B, H // p, p, W // p, p, C) \
            .permute(0, 1, 3, 2, 4, 5).reshape(B, -1, p * p * C)
        x = self._mm(patches, kernel.reshape(p * p * C, D))
        cls = self.w["class_embedding"].expand(B, 1, D)
        x = torch.cat([cls, x], 1) + self.w["positional_embedding"]
        x = self._ln(x, "ln_pre")
        for i in range(self.layers):
            b = f"blocks.{i}"
            x = x + self._attention(self._ln(x, b + ".ln_1"), b + ".attn")
            y = self._dense(self._ln(x, b + ".ln_2"), b + ".mlp_fc")
            x = x + self._dense(y * torch.sigmoid(1.702 * y), b + ".mlp_proj")
        return self._mm(self._ln(x[:, 0], "ln_post"), self.w["proj"])


@torch.no_grad()
def symbols(tower: Tower, images_uint8: torch.Tensor, scaling, biasing,
            medians, block: int = 256) -> torch.Tensor:
    """The hub's int64 symbols of raw images: round((z + biasing) *
    exp(scaling) - median), in blocks of `block` images."""
    out = []
    for i in range(0, len(images_uint8), block):
        z = tower(preprocess(images_uint8[i:i + block]))
        out.append(torch.round((z + biasing) * torch.exp(scaling)
                               - medians).long())
    return torch.cat(out)
