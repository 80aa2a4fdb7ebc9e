"""The benchmark's yardstick: the card's peaks and the operations and bytes
of the work, counted from shapes.

Operations are floating-point operations (a multiply-add is 2). A
kernel's bound is the larger of its operations over the peak rate and its
bytes over the memory bandwidth, with every input byte read once and
every output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for the work, in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# -- CLIP ViT-B/32 --------------------------------------------------------

def vit_tokens(image: int, patch: int) -> int:
    return (image // patch) ** 2 + 1


def vit_forward_flops(width: int, layers: int, patch: int, image: int,
                      out_dim: int) -> float:
    """One image through the tower: the patchify product over the patches,
    every block over all tokens (its four projections, the two products
    of attention, the 4x MLP) and the head's projection."""
    n = vit_tokens(image, patch)
    d, ff = width, 4 * width
    block = 2 * (4 * n * d * d + 2 * n * n * d + 2 * n * d * ff)
    patchify = 2 * (n - 1) * d * (patch * patch * 3)
    return float(layers * block + patchify + 2 * d * out_dim)


def attention_bound_s(batch: int, tokens: int, heads: int, head_dim: int,
                      itemsize: int = 2) -> float:
    """K1, self-attention over the fused (B, N, 3D) projections: reads
    q, k and v, writes (B, N, D)."""
    D = heads * head_dim
    nbytes = batch * tokens * 3 * D * itemsize + batch * tokens * D * itemsize
    flops = 4 * batch * heads * tokens * tokens * head_dim
    return bound_s(flops, nbytes, "bfloat16")


def attention_cls_bound_s(batch: int, tokens: int, heads: int,
                          head_dim: int, itemsize: int = 2) -> float:
    """K2, the class token's query against (B, N, 2D) keys and values:
    reads q0, k and v, writes (B, 1, D)."""
    D = heads * head_dim
    nbytes = (batch * D + batch * tokens * 2 * D + batch * D) * itemsize
    flops = 4 * batch * heads * tokens * head_dim
    return bound_s(flops, nbytes, "bfloat16")


def vit_attention_bound_s(batch: int, layers: int, tokens: int, heads: int,
                          head_dim: int) -> float:
    """The attention of one tower forward: K1 in every block but the last,
    K2 in the last (it computes the class token alone)."""
    return (layers - 1) * attention_bound_s(batch, tokens, heads, head_dim) \
        + attention_cls_bound_s(batch, tokens, heads, head_dim)


# -- ResNet-18 and the BINCE step -----------------------------------------

def conv_flops(h: int, w: int, cin: int, cout: int, k: int,
               stride: int) -> float:
    """A k x k convolution with 'same' padding, no bias."""
    return 2.0 * (h // stride) * (w // stride) * cout * cin * k * k


def resnet18_forward_flops(h: int, w: int, channels: int = 3,
                           out_dim: int = 128) -> tuple[float, float]:
    """(all convolutions and the head, the stem alone) of one image through
    ResNet-18 with the small-image stem (3 x 3 stride 1, no max-pool)."""
    stem = conv_flops(h, w, channels, 64, 3, 1)
    total, cin = stem, 64
    for i in range(4):
        cout = 64 * 2 ** i
        for j in range(2):
            s = 2 if i > 0 and j == 0 else 1
            total += conv_flops(h, w, cin, cout, 3, s)
            h, w = h // s, w // s
            total += conv_flops(h, w, cout, cout, 3, 1)
            if s != 1 or cin != cout:
                total += conv_flops(h * s, w * s, cin, cout, 1, s)
            cin = cout
    return total + 2.0 * cin * out_dim, stem


def mlp_flops(dims) -> float:
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def bince_train_flops(h: int, w: int, z_dim: int, project_dim: int,
                      probe_hidden: int, n_classes: int) -> float:
    """One sample of a BINCE training step: the anchor and its positive
    each through ResNet-18 and the projector, forward and backward (twice
    the forward; the stem takes no gradient of its input), and the probe
    on the anchor's z, forward and backward of its weights."""
    enc, stem = resnet18_forward_flops(h, w, 3, z_dim)
    proj = mlp_flops((z_dim, project_dim, project_dim))
    probe = mlp_flops((z_dim, probe_hidden, n_classes))
    per_view = 3 * (enc + proj) - stem
    return 2 * per_view + 2 * probe


def k3_coefficients(filters) -> int:
    widths = (1, *filters, 1)
    pairs = list(zip(widths[:-1], widths[1:]))
    return sum(o * i + o for i, o in pairs) + sum(o for _, o in pairs[:-1])


def _k3_chain(filters) -> int:
    widths = (1, *filters, 1)
    L = len(widths) - 1
    return sum(2 * o * i + o + (3 * o if l < L - 1 else 0)
               for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])))


def k3_forward_bound_s(batch: int, channels: int, filters) -> float:
    """The likelihood: two chains a value, the sign and the floor; reads z
    and the coefficients, writes the likelihoods (float32)."""
    flops = batch * channels * (2 * _k3_chain(filters) + 10)
    nbytes = 2 * batch * channels * 4 \
        + channels * k3_coefficients(filters) * 4
    return bound_s(flops, nbytes, "float32")


def k3_backward_bound_s(batch: int, channels: int, filters) -> float:
    """The likelihood's backward: both chains again, the sign and the
    pass-through, back through both chains; reads z, the upstream
    gradient and the coefficients, writes the input's and the
    coefficients' gradients."""
    widths = (1, *filters, 1)
    L = len(widths) - 1
    back = sum(4 * o * i + o + (5 * o if l < L - 1 else 0)
               for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])))
    flops = batch * channels * (2 * _k3_chain(filters) + 20 + 2 * back)
    nbytes = 3 * batch * channels * 4 \
        + 2 * channels * k3_coefficients(filters) * 4
    return bound_s(flops, nbytes, "float32")
