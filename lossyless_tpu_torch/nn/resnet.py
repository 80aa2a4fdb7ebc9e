"""ResNet encoders (18/34/50) with the small-image stem.

Counterpart of `lossyless_tpu/nn/resnet.py`: torchvision's ResNets whose
stem is a 3x3 stride-1 conv with no max-pool when the input's shorter
side is below 100 px (MNIST, CIFAR), else the 7x7 stride-2 conv and the
3x3 / 2 max-pool; the pooled features go through a `Dense` head to
`out_dim`. Parameters keep flax's names (`Conv_0`, `BatchNorm_0`,
`BasicBlock_3`, `BottleneckBlock_5`, `Dense_0`), so a JAX tree carries
over through `layers.params_from_flax`.

NHWC in, as JAX; inside, the NCHW view of the NHWC tensor (a
`torch.channels_last` tensor, cuDNN's layout for bf16 tensor-core
convolutions; on the card made so in memory by `layers.conv_input`, so
every activation keeps its channels innermost). Under `dtype=bfloat16`
flax's rounding points are kept: each conv bf16 in and out, BatchNorm
fp32 params and fp32 out, ReLU then a cast to bf16, the residual add in
fp32, the pool and the head fp32. BatchNorm: momentum 0.9 in flax's sense
(torch's 0.1), eps 1e-5; on the card the kernel pair K6 (fp32 arithmetic,
`nn/csrc/batchnorm.cu`), on the CPU the eager fp32 chain.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LECUN_NORMAL, BatchNorm, Conv, conv_input
from .mlp import Dense, _dtype


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(cin, filters, 3, strides, 1, False, dtype,
                           generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, 1, 1, False, dtype,
                           generator)
        self.BatchNorm_1 = BatchNorm(filters)
        self.shortcut = cin != filters or strides != 1
        if self.shortcut:
            self.Conv_2 = Conv(cin, filters, 1, strides, 0, False, dtype,
                               generator)
            self.BatchNorm_2 = BatchNorm(filters)

    def forward(self, x, *, training: bool = False):
        y = self.BatchNorm_0(self.Conv_0(x), training=training)
        y = F.relu(y).to(self.dtype)
        y = self.BatchNorm_1(self.Conv_1(y), training=training)
        r = self.BatchNorm_2(self.Conv_2(x), training=training) \
            if self.shortcut else x
        return F.relu(y + r)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        out = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, 0, False, dtype, generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, 1, False, dtype,
                           generator)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, 1, 0, False, dtype, generator)
        self.BatchNorm_2 = BatchNorm(out)
        self.shortcut = cin != out or strides != 1
        if self.shortcut:
            self.Conv_3 = Conv(cin, out, 1, strides, 0, False, dtype,
                               generator)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x, *, training: bool = False):
        y = self.BatchNorm_0(self.Conv_0(x), training=training)
        y = F.relu(y).to(self.dtype)
        y = self.BatchNorm_1(self.Conv_1(y), training=training)
        y = F.relu(y).to(self.dtype)
        y = self.BatchNorm_2(self.Conv_2(y), training=training)
        r = self.BatchNorm_3(self.Conv_3(x), training=training) \
            if self.shortcut else x
        return F.relu(y + r)


STAGES = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (BottleneckBlock, (3, 4, 6, 3)),
}


class ResNet(nn.Module):
    """Image (B, H, W, C) -> vector (B, out_dim), or the pooled features
    with `is_no_linear`."""

    def __init__(self, out_dim: int, in_shape: Sequence[int],
                 base: str = "resnet18", is_no_linear: bool = False,
                 dtype="float32", generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        self.is_no_linear = is_no_linear
        block, stage_sizes = STAGES[base]
        g = generator or torch.Generator().manual_seed(0)
        h, w, c = in_shape
        self.small_input = min(h, w) < 100
        if self.small_input:
            self.Conv_0 = Conv(c, 64, 3, 1, 1, False, d, g)
        else:
            self.Conv_0 = Conv(c, 64, 7, 2, 3, False, d, g)
        self.BatchNorm_0 = BatchNorm(64)
        self.blocks = []
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = 64 * 2 ** i
                blk = block(cin, filters, 2 if i > 0 and j == 0 else 1, d, g)
                self.add_module(f"{block.__name__}_{len(self.blocks)}", blk)
                self.blocks.append(blk)
                cin = filters * block.expansion
        if not is_no_linear:
            self.Dense_0 = Dense(cin, out_dim, generator=g,
                                 kernel_init=LECUN_NORMAL)

    def forward(self, x, *, training: bool = False):
        d = self.dtype
        x = conv_input(x.permute(0, 3, 1, 2), d)   # NHWC -> its NCHW view
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), training=training))
        if not self.small_input:
            x = F.max_pool2d(x, 3, 2, 1)
        x = x.to(d)
        for blk in self.blocks:
            x = blk(x, training=training).to(d)
        x = x.float().mean((2, 3))               # fp32 pool
        return x if self.is_no_linear else self.Dense_0(x)
