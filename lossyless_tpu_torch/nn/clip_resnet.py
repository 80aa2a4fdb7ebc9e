"""OpenAI CLIP's ModifiedResNet visual tower (RN50).

Counterpart of `lossyless_tpu/nn/clip_resnet.py`, not a torchvision
ResNet but CLIP's variant:

* a 3-conv stem (3x3 / 2 -> 3x3 -> 3x3, each BatchNorm + ReLU) and a 2x2
  average pool in place of the 7x7 / 2 conv and the max pool;
* anti-aliased downsampling: every strided convolution is a stride-1
  convolution with a 2x2 average pool at the stride point, in the
  bottleneck's body and in its shortcut;
* an `AttentionPool2d` head: the spatial features flatten to tokens, a
  mean token is prepended, a learned positional embedding is added, and
  one multi-head attention read-out with the mean token as its only query
  (separate q / k / v / c projections) gives the `out_dim` embedding.

The read-out is K2's problem (`nn/flash_attn.py::fused_attention_cls`, a
token-0 query over N tokens): `attn_impl="kernel"` runs the hand-written
kernel on CUDA tensors (its plain version on CPU tensors), `"plain"` the
plain version `attention_cls_plain`.

Parameters keep flax's names (`conv1`, `bn1`, `layer2_0.downsample_conv`,
`attnpool.q_proj.kernel`, ...), so a JAX tree carries over through
`layers.params_from_flax`. NHWC in, as JAX; inside, the NCHW view of it.
Rounding points under `dtype=bfloat16` are flax's: each conv bf16 in and
out, BatchNorm fp32 out, ReLU, then a cast to bf16; `bn3` plus the
identity summed in fp32, ReLU, cast by the stage loop; in the pool the
mean token in bf16, `t + pe` in fp32 (pe is an fp32 parameter) cast to
bf16, the projections and K2 in bf16, the output fp32.

torch needs the positional embedding's shape at construction, so the tower
takes `in_shape`; the token grid is flax's arithmetic: the stem's 3x3 / 2
conv (padding 1) gives (H - 1) // 2 + 1, each of the four 2x2 VALID
average pools floors, so a 100 px input has a 3x3 grid (50 -> 25 -> 12
-> 6 -> 3).

`convert_clip_resnet` maps an OpenAI CLIP RN50 state dict (bare or
`visual.`-prefixed, fp16 as CLIP ships it) onto this module's state dict.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .flash_attn import attention_cls_plain, fused_attention_cls
from .layers import (LECUN_NORMAL, BatchNorm, Conv, numpy_state_dict,
                     params_from_flax)
from .mlp import Dense, _dtype


def _lecun_conv(conv: Conv, generator: torch.Generator):
    """flax `nn.Conv`'s default init (LeCun truncated normal over the
    fan-in kh * kw * in) on a `Conv`'s (out, in, kh, kw) kernel."""
    cout, cin, kh, kw = conv.kernel.shape
    k = LECUN_NORMAL((kh * kw * cin, cout), generator)
    with torch.no_grad():
        conv.kernel.copy_(k.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1))


def avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """flax's `nn.avg_pool(x, (s, s), (s, s))` (VALID) on an NCHW view,
    with its rounding: the window's taps summed one at a time in x's dtype
    (row-major), then divided by s * s. `F.avg_pool2d` sums in fp32 and
    rounds once, which moves a third of the bf16 outputs by an ulp."""
    h, w = x.shape[2] // s * s, x.shape[3] // s * s
    out = None
    for i in range(s):
        for j in range(s):
            tap = x[:, :, i:h:s, j:w:s]
            out = tap if out is None else out + tap
    return out / (s * s)


class ClipBottleneck(nn.Module):
    """CLIP bottleneck: stride-1 convs, a 2x2 average pool at the stride
    point."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype, self.stride = dtype, stride
        out = planes * 4
        self.conv1 = Conv(cin, planes, 1, 1, 0, False, dtype, generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, False, dtype, generator)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, out, 1, 1, 0, False, dtype, generator)
        self.bn3 = BatchNorm(out)
        self.shortcut = stride > 1 or cin != out
        if self.shortcut:
            self.downsample_conv = Conv(cin, out, 1, 1, 0, False, dtype,
                                        generator)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x, *, training: bool = False):
        d, s = self.dtype, self.stride
        y = F.relu(self.bn1(self.conv1(x), training=training)).to(d)
        y = F.relu(self.bn2(self.conv2(y), training=training)).to(d)
        if s > 1:
            y = avg_pool(y, s)
        y = self.bn3(self.conv3(y), training=training)
        r = x
        if self.shortcut:
            if s > 1:
                r = avg_pool(r, s)
            r = self.downsample_bn(self.downsample_conv(r), training=training)
        return F.relu(y + r)


class AttentionPool2d(nn.Module):
    """Mean-token attention read-out over an (B, C, gh, gw) feature map."""

    def __init__(self, width: int, n_tokens: int, heads: int, out_dim: int,
                 dtype=torch.float32, attn_impl: str = "kernel",
                 generator=None):
        super().__init__()
        if attn_impl not in ("kernel", "plain"):
            raise ValueError(f"unknown attn_impl={attn_impl!r}")
        self.heads, self.dtype, self.attn_impl = heads, dtype, attn_impl
        g = generator or torch.Generator().manual_seed(0)
        self.positional_embedding = nn.Parameter(
            torch.randn(n_tokens, width, generator=g) * width ** -0.5)
        for name, cout in (("q_proj", width), ("k_proj", width),
                           ("v_proj", width), ("c_proj", out_dim)):
            self.add_module(name, Dense(width, cout, dtype=dtype,
                                        generator=g,
                                        kernel_init=LECUN_NORMAL))

    def forward(self, x):
        d = self.dtype
        t = x.flatten(2).transpose(1, 2)                 # (B, gh * gw, C)
        t = torch.cat([t.mean(1, keepdim=True), t], dim=1)
        if t.shape[1] != self.positional_embedding.shape[0]:
            raise ValueError(
                f"the feature map gives {t.shape[1] - 1} tokens but the "
                f"tower was built for "
                f"{self.positional_embedding.shape[0] - 1}; construct it "
                f"with in_shape matching the data resolution")
        t = (t + self.positional_embedding[None]).to(d)
        q0 = self.q_proj(t[:, :1])
        kv = torch.cat([self.k_proj(t), self.v_proj(t)], dim=-1)
        attend = fused_attention_cls if self.attn_impl == "kernel" \
            else attention_cls_plain
        return self.c_proj(attend(q0, kv, self.heads))[:, 0]


def token_grid(h: int, w: int) -> tuple[int, int]:
    """The attention pool's grid for an h x w input: the stem's 3x3 / 2
    conv with padding 1, then four 2x2 VALID average pools."""
    return tuple(((s - 1) // 2 + 1) // 16 for s in (h, w))


class ClipResNet(nn.Module):
    """CLIP RN50-style tower: NHWC float images -> (B, out_dim) fp32."""

    def __init__(self, out_dim: int = 1024,
                 in_shape: Sequence[int] = (224, 224, 3),
                 layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 heads: int = 32, dtype="float32",
                 attn_impl: str = "kernel",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = in_shape
        half = width // 2
        for i, (cin, cout) in enumerate(((c, half), (half, half),
                                         (half, width)), start=1):
            self.add_module(f"conv{i}", Conv(cin, cout, 3, 2 if i == 1
                                             else 1, 1, False, d, g))
            self.add_module(f"bn{i}", BatchNorm(cout))
        self.blocks = []
        cin = width
        for i, n_blocks in enumerate(layers):
            planes = width * 2 ** i
            for j in range(n_blocks):
                blk = ClipBottleneck(cin, planes, 2 if i > 0 and j == 0
                                     else 1, d, g)
                self.add_module(f"layer{i + 1}_{j}", blk)
                self.blocks.append(blk)
                cin = planes * 4
        for m in self.modules():
            if isinstance(m, Conv):
                _lecun_conv(m, g)
        gh, gw = token_grid(h, w)
        self.attnpool = AttentionPool2d(cin, gh * gw + 1, heads, out_dim, d,
                                        attn_impl, g)

    def forward(self, x, *, training: bool = False):
        d = self.dtype
        x = x.permute(0, 3, 1, 2).to(d)          # NHWC -> its NCHW view
        for i in (1, 2, 3):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x, training=training)).to(d)
        x = avg_pool(x, 2)
        for blk in self.blocks:
            x = blk(x, training=training).to(d)
        return self.attnpool(x).float()


def convert_clip_resnet(torch_state_dict) -> dict:
    """OpenAI CLIP RN50 `visual.*` weights -> this module's state dict
    (parameters and BatchNorm running statistics).

    Accepts the state dict of the full CLIP model or of the visual tower
    alone; the stage and block counts are read off the keys, so the
    scaled RN50x4-style variants convert too. Returns what the JAX
    package's converter, followed by `params_from_flax` of its parameters
    and statistics merged, returns.
    """
    items = torch_state_dict
    if any(k.startswith("visual.") for k in torch_state_dict):
        items = {k[len("visual."):]: v for k, v in torch_state_dict.items()
                 if k.startswith("visual.")}
    sd = numpy_state_dict(items)

    def conv(name):
        return {"kernel": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}

    def bn(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"],
                "mean": sd[f"{name}.running_mean"],
                "var": sd[f"{name}.running_var"]}

    def linear(name):
        return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}

    tree = {}
    for i in (1, 2, 3):
        tree[f"conv{i}"] = conv(f"conv{i}")
        tree[f"bn{i}"] = bn(f"bn{i}")
    stage = 1
    while f"layer{stage}.0.conv1.weight" in sd:
        j = 0
        while f"layer{stage}.{j}.conv1.weight" in sd:
            t = f"layer{stage}.{j}"
            blk = {}
            for i in (1, 2, 3):
                blk[f"conv{i}"] = conv(f"{t}.conv{i}")
                blk[f"bn{i}"] = bn(f"{t}.bn{i}")
            # CLIP's shortcut is Sequential(("-1", avgpool), ("0", conv),
            # ("1", bn)); the pool has no parameters
            if f"{t}.downsample.0.weight" in sd:
                blk["downsample_conv"] = conv(f"{t}.downsample.0")
                blk["downsample_bn"] = bn(f"{t}.downsample.1")
            tree[f"layer{stage}_{j}"] = blk
            j += 1
        stage += 1
    tree["attnpool"] = {
        "positional_embedding": sd["attnpool.positional_embedding"],
        **{p: linear(f"attnpool.{p}")
           for p in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return params_from_flax(tree)
