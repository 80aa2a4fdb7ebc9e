"""Fused multi-head attention for short token sequences (CUDA, Hopper).

Counterpart of the Pallas kernels in `lossyless_tpu/nn/flash_attn.py`:

* K1 `fused_attention(qkv, heads)` — MHSA straight off the fused qkv
  projection in its natural (B, N, 3D) layout, out (B, N, D). Replaces
  `fused_attention` / `_attn_kernel`. Runs the attention of CLIP ViT
  blocks 0..L-2. In bf16 at N <= 64 a TMA-fed tensor-core tile (wgmma)
  where d is a multiple of 16 and the pointers are 16-byte aligned, else
  the cp.async one-pass tile; fp32 and longer sequences the CUDA-core row
  code.
* K2 `fused_attention_cls(q0, kv, heads)` — the class-token query only:
  q0 (B, 1, D), kv (B, N, 2D), out (B, 1, D). Replaces
  `fused_attention_cls` / `_attn_cls_kernel`. Runs the last ViT block.
* K5a (packed) and K5b (head-batched) — K1's function on the TPU's two
  other layouts, chosen inside `fused_attention` by the module knobs
  `IMAGE_PACK` and `HEAD_BATCH`, as JAX's `fused_attention` chooses
  `_attn_kernel_packed` / `_attn_kernel_headbatched`. The TPU's K5a
  stacks `pack` images' tokens into one (pack*N)-token operand per head
  under a block-diagonal -1e9 mask, whose masked blocks add exactly 0;
  K5b folds the heads into the batch of its dots. On the card both run,
  in bf16 at N <= 64, K1's kernels with K1's (image, head) items, K5a's
  masked blocks skipped; longer sequences take the two-pass tile and fp32
  the CUDA-core row code.
* K4 `fused_mlp_block(x, ln_scale, ln_bias, fc_w, fc_b, pr_w, pr_b)` —
  the MLP half-block `x + proj(QuickGELU(fc(LN(x))))`, bf16, with the TPU
  kernel's rounding points. Replaces `fused_mlp_block` / `_mlp_kernel`.
  Runs the MLP of ViT blocks 0..L-2 with `mlp_impl="kernel"`. Widths that
  are multiples of 64 take the wgmma design (a LayerNorm pass and two
  persistent wgmma products fed by TMA, the bf16 hidden through device
  memory); others the one-kernel mma.sync design.

K1, K2, K5a and K5b are CUDA C++ in `csrc/attention.cu`, K4 in
`csrc/mlp_block.cu` (design and bounds noted there), built with nvcc at
first use (`_build.py`) and called through ctypes on PyTorch's current
stream. Each wrapper checks device, dtype, shape and contiguity,
allocates the output, launches, raises if the launch returned a CUDA
error, and adds one to its entry of `LAUNCHES`. K2's launch geometry
(blocks, warps a block, shared memory, and the 16-byte or element load
path) is chosen here, by the pure function `k2_plan`, K1's design and
geometry by `k1_plan`, K5a's and K5b's by `k5_plan`, and K4's by
`k4_plan`; the CPU tests check each at every shape the card's checks
run.

The module knob `SOFTMAX_DTYPE` (JAX's, default float32) narrows K1's and
K2's max / exp / sum chain to bfloat16 at the TPU kernels' rounding
points, in the plain versions and in every design of the kernels; with
`IMAGE_PACK > 1` or `HEAD_BATCH` a bf16 softmax raises, as in JAX.

A CPU tensor goes to the plain version (`attention_plain`,
`attention_packed_plain`, `attention_headbatched_plain`,
`attention_cls_plain`, `mlp_block_plain`: plain torch with the kernel's
arithmetic). A CUDA tensor goes to the kernel or the call raises; nothing
falls back. The backward of each recomputes through the plain version, as
the JAX `custom_vjp`s do; all three variants of `fused_attention` go back
through `attention_plain`, as JAX routes them through one `custom_vjp`.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

# launches of each kernel, counted where the kernel is launched and nowhere
# else (a run reads them to show its main path went through the kernels);
# K1's and K2's bf16-softmax instantiations (`SOFTMAX_DTYPE=bfloat16`) have
# keys of their own
LAUNCHES = {"fused_attention": 0, "fused_attention_cls": 0,
            "fused_attention_bf16_softmax": 0,
            "fused_attention_cls_bf16_softmax": 0,
            "fused_attention_packed": 0, "fused_attention_headbatched": 0,
            "fused_mlp_block": 0}

# The JAX package's variant knobs (`lossyless_tpu/nn/flash_attn.py:77-97`),
# same names and defaults. IMAGE_PACK > 1 runs K5a with that many images
# per packed operand (after the pack rule, `effective_pack`); else
# HEAD_BATCH runs K5b; else K1. BLOCK_LIMIT is JAX's images-per-grid-step
# cap, which the pack rule reads.
IMAGE_PACK = 1
HEAD_BATCH = False
BLOCK_LIMIT = 16
# JAX's SOFTMAX_DTYPE (`flash_attn.py:99-108`): the dtype of K1's and K2's
# max / exp / sum chain. float32 is the parity default; bfloat16 rounds
# where the TPU kernels round (`_scaled_softmax_to`), in the plain versions
# and in every design of the kernels. K5a and K5b refuse it, as JAX does.
SOFTMAX_DTYPE = torch.float32

MAX_D = 128
MAX_SMEM = 232448          # bytes of shared memory a Hopper block can use
K1_WARPS = 8               # row code: warps per (image, head) block
TILE_MAX_N = 64            # the TMA/wgmma tile: the longest sequence
TILE_THREADS = 384         # a producer and two consumer warpgroups
TILE_BOX = 64 * 128        # bytes of a TMA box's region (64 rows of 128)
TILE_STAGES = 4            # ring stages (attention.cu kTileStages)
K2_WARPS = 8               # K2: one (image, head) item a warp
K5_WARPS = 8               # K5a/K5b two-pass and fp32: warps take row items
K5_ONEPASS_MAX_N = 64      # the longest sequence the one-pass tile takes
K5_STAGES = 2              # one-pass ring stages (attention.cu kStages)
K5_SMS = 132               # SMs of an H100 SXM
K5_BLOCKS_PER_SM = 4       # one-pass blocks the plan aims to keep on an SM
K5_PASS_BUDGET = 116224    # K5b two-pass: a pass's bytes (half an SM)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from . import _build

                lib = _build.load("attention")
                i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
                lib.lossyless_attention_smem_bytes.restype = ctypes.c_size_t
                lib.lossyless_attention_smem_bytes.argtypes = [i, i, i, i]
                lib.lossyless_fused_attention.restype = i
                lib.lossyless_fused_attention.argtypes = [
                    p, p, i, i, i, i, i, f, i, i, i, p]
                lib.lossyless_attention_k2_smem_bytes.restype = \
                    ctypes.c_size_t
                lib.lossyless_attention_k2_smem_bytes.argtypes = [i, i, i]
                lib.lossyless_fused_attention_cls.restype = i
                lib.lossyless_fused_attention_cls.argtypes = [
                    p, p, p, i, i, i, i, i, f, i, i, i, i, p]
                lib.lossyless_attention_packed_smem_bytes.restype = \
                    ctypes.c_size_t
                lib.lossyless_attention_packed_smem_bytes.argtypes = [
                    i, i, i, i]
                lib.lossyless_fused_attention_packed.restype = i
                lib.lossyless_fused_attention_packed.argtypes = [
                    p, p, i, i, i, i, i, i, f, i, i, p]
                lib.lossyless_attention_headbatched_smem_bytes.restype = \
                    ctypes.c_size_t
                lib.lossyless_attention_headbatched_smem_bytes.argtypes = [
                    i, i, i, i, i]
                lib.lossyless_fused_attention_headbatched.restype = i
                lib.lossyless_fused_attention_headbatched.argtypes = [
                    p, p, i, i, i, i, i, f, i, i, i, p]
                lib.lossyless_attention_k5_onepass_smem_bytes.restype = \
                    ctypes.c_size_t
                lib.lossyless_attention_k5_onepass_smem_bytes.argtypes = [
                    i, i]
                lib.lossyless_fused_attention_k5_onepass.restype = i
                lib.lossyless_fused_attention_k5_onepass.argtypes = [
                    p, p, i, i, i, i, f, i, i, i, i, p]
                lib.lossyless_attention_tile_smem_bytes.restype = \
                    ctypes.c_size_t
                lib.lossyless_attention_tile_smem_bytes.argtypes = [i]
                lib.lossyless_fused_attention_tile.restype = i
                lib.lossyless_fused_attention_tile.argtypes = [
                    p, p, i, i, i, i, f, i, ctypes.c_size_t, i, i, p]
                _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in plain torch
# ---------------------------------------------------------------------------


def _softmax_to(logits: torch.Tensor, dtype) -> torch.Tensor:
    """fp32 row softmax as `p / sum`, cast to the io dtype."""
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return (p / p.sum(dim=-1, keepdim=True)).to(dtype)


def softmax_dtype(softmax=None):
    """The softmax chain's dtype: `softmax`, else the `SOFTMAX_DTYPE`
    knob; float32 or bfloat16."""
    sm = SOFTMAX_DTYPE if softmax is None else softmax
    if sm not in (torch.float32, torch.bfloat16):
        raise ValueError(f"SOFTMAX_DTYPE must be torch.float32 or "
                         f"torch.bfloat16, got {sm}")
    return sm


def _scaled_softmax_to(logits: torch.Tensor, scale: float, dtype,
                       softmax=None) -> torch.Tensor:
    """K1's and K2's softmax of the fp32 `logits` (the dot, unscaled), cast
    to the io dtype. In fp32: scaled after the dot, `_softmax_to`. In bf16,
    the TPU kernels' chain (JAX `_attn_kernel` :55-69): the logits rounded
    to bf16 times the bf16 scale, rounded; the max; l - max and its exp,
    each rounded; the exps summed in fp32 (`jnp.sum` upcasts bf16), the sum
    rounded once; p / sum rounded."""
    sm = softmax_dtype(softmax)
    if sm == torch.float32:
        return _softmax_to(logits * scale, dtype)
    lg = logits.to(sm) * torch.tensor(scale, dtype=sm)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    s = p.sum(dim=-1, keepdim=True, dtype=torch.float32).to(sm)
    return (p / s).to(dtype)


def attention_plain(qkv: torch.Tensor, heads: int,
                    softmax=None) -> torch.Tensor:
    """Plain K1: (B, N, 3D) -> (B, N, D).

    q.k accumulates in fp32 and is scaled by d^-1/2 after the dot; softmax
    in `softmax` (default: the `SOFTMAX_DTYPE` knob; `_scaled_softmax_to`);
    probabilities cast to the io dtype before an fp32 P.V.
    """
    B, N, threeD = qkv.shape
    D = threeD // 3
    d = D // heads
    q, k, v = qkv.float().split(D, dim=-1)
    q = q.reshape(B, N, heads, d)
    k = k.reshape(B, N, heads, d)
    v = v.reshape(B, N, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    attn = _scaled_softmax_to(logits, d**-0.5, qkv.dtype, softmax).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, N, D).to(qkv.dtype)


def _heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, heads*d) -> (heads*B, N, d), head-major as JAX's
    `heads_first` concatenation."""
    B, N, D = t.shape
    return t.reshape(B, N, heads, D // heads).permute(2, 0, 1, 3) \
        .reshape(heads * B, N, D // heads)


def attention_packed_plain(qkv: torch.Tensor, heads: int,
                           pack: int) -> torch.Tensor:
    """Plain K5a (`_attn_kernel_packed`): per head, `pack` consecutive
    images' tokens stacked into one (M = pack*N, d) operand; the fp32
    (M, M) logits, scaled after the dot, get the additive block-diagonal
    mask (0 within an image, -1e9 across) before the softmax."""
    B, N, threeD = qkv.shape
    D = threeD // 3
    d = D // heads
    if pack < 1 or B % pack:
        raise ValueError(f"pack={pack} does not divide the batch {B}")
    M = pack * N
    img = torch.arange(M, device=qkv.device) // N
    amask = torch.where(img[:, None] == img[None, :], 0.0, -1e9)
    q, k, v = (_heads_first(t.reshape(B // pack, M, D), heads)
               for t in qkv.float().split(D, dim=-1))
    logits = torch.bmm(q, k.transpose(1, 2)) * d**-0.5 + amask
    attn = _softmax_to(logits, qkv.dtype).float()
    out = torch.bmm(attn, v)                       # (heads * B/pack, M, d)
    out = out.reshape(heads, B // pack, M, d).permute(1, 2, 0, 3)
    return out.reshape(B, N, D).to(qkv.dtype)


def attention_headbatched_plain(qkv: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """Plain K5b (`_attn_kernel_headbatched`): all heads folded into the
    batch of one pair of dots, (heads*B, N, d) operands."""
    B, N, threeD = qkv.shape
    D = threeD // 3
    d = D // heads
    q, k, v = (_heads_first(t, heads) for t in qkv.float().split(D, dim=-1))
    logits = torch.bmm(q, k.transpose(1, 2)) * d**-0.5
    attn = _softmax_to(logits, qkv.dtype).float()
    out = torch.bmm(attn, v).reshape(heads, B, N, d).permute(1, 2, 0, 3)
    return out.reshape(B, N, D).to(qkv.dtype)


# ---------------------------------------------------------------------------
# The pack rule: which images K5a packs together, as JAX decides it
# (`fused_attention`, `flash_attn.py:221-227, 240-244`)
# ---------------------------------------------------------------------------


def _block_size(B: int, limit: int | None = None) -> int:
    if limit is None:
        limit = BLOCK_LIMIT
    for g in range(min(limit, B), 0, -1):
        if B % g == 0:
            return g
    return 1


def _vmem_block_limit(per_image_bytes: int, budget: int = 4 << 20) -> int:
    """JAX's cap on images per grid step for a 4 MiB block budget."""
    return max(1, min(BLOCK_LIMIT, budget // max(1, per_image_bytes)))


def effective_pack(B: int, N: int, threeD: int, itemsize: int) -> int:
    """Images per packed operand for `IMAGE_PACK` at this shape: JAX's
    image block G for the qkv block, `min(IMAGE_PACK, G)`, stepped down to
    a divisor of G. The packed images are consecutive, so this packs the
    same images together as JAX does (its rebudgeted block size is a
    multiple of the pack and changes no grouping)."""
    G = _block_size(B, _vmem_block_limit(N * threeD * itemsize))
    pack = max(1, min(IMAGE_PACK, G))
    while G % pack:
        pack -= 1
    return pack


def attention_cls_plain(q0: torch.Tensor, kv: torch.Tensor, heads: int,
                        softmax=None) -> torch.Tensor:
    """Plain K2: q0 (B, 1, D), kv (B, N, 2D) -> (B, 1, D); the softmax
    chain as `attention_plain`'s."""
    B, N, twoD = kv.shape
    D = twoD // 2
    d = D // heads
    k, v = kv.float().split(D, dim=-1)
    q = q0.float().reshape(B, 1, heads, d)
    k = k.reshape(B, N, heads, d)
    v = v.reshape(B, N, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    attn = _scaled_softmax_to(logits, d**-0.5, kv.dtype, softmax).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, 1, D).to(kv.dtype)


# ---------------------------------------------------------------------------
# K2's launch plan (a pure function of shape, dtype and alignment)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class K2Plan:
    """The launch geometry of one K2 call: `blocks` blocks of `warps`
    warps, a warp per (image, head) item (item = b * heads + h; warp w of
    block i takes item i * warps + w), `smem` bytes of shared memory a
    block. vec: the 16-byte load path; else element loads."""

    items: int
    warps: int
    blocks: int
    smem: int
    vec: bool


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def sixteen_byte_path(d: int, itemsize: int, aligned: bool) -> bool:
    """Whether 16-byte loads describe the tensors: every base 16-byte
    aligned and the head dim a whole number of 16-byte chunks (so every
    row and head offset is aligned too). The condition a TMA descriptor
    needs as well; where it fails the kernel takes its element path."""
    return aligned and (d * itemsize) % 16 == 0


@functools.lru_cache(maxsize=256)
def k2_plan(B: int, N: int, heads: int, d: int, dtype,
            aligned: bool = True) -> K2Plan:
    """K2's geometry: one warp per (image, head) item, `K2_WARPS` warps a
    block (fewer when there are fewer items), each with shared memory for
    q0 and its probabilities (d and N rounded up to 4 floats).
    `aligned`: q0's, kv's and the output's data pointers are 16-byte
    aligned."""
    items = B * heads
    warps = min(K2_WARPS, items)
    smem = 4 * warps * (_round_up(d, 4) + _round_up(N, 4))
    _check_smem(smem, f"N={N} ({warps} warps)")
    return K2Plan(items, warps, -(-items // warps), smem,
                  sixteen_byte_path(d, dtype.itemsize, aligned))


# ---------------------------------------------------------------------------
# K1's, K5a's and K5b's launch plans (pure functions of shape, dtype, pack
# and alignment)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionPlan:
    """The design and geometry of one K1 (`k1_plan`), K5a (pack >= 2) or
    K5b (pack 1) call (`k5_plan`).

    design:
    * "wgmma": bf16, N <= `TILE_MAX_N`, d a multiple of 16 up to 128,
      16-byte-aligned input and output: the TMA-fed tensor-core tile,
      `blocks` persistent blocks (at most one an SM) of `warps` warps, a
      ring of `TILE_STAGES` stages fixed in the kernel; block i takes items
      i, i + blocks, ... (`per_block` at most);
    * "onepass": bf16, N <= 64 outside the tile's scope: the cp.async
      one-pass tile, `K5_STAGES` stages fixed in the kernel; block i takes
      the run of items [i * per_block, (i + 1) * per_block), the last run
      possibly short;
    * "rows" (K1: fp32, bf16 N > 64): the CUDA-core row code, one block
      per (image, head);
    * "twopass" (K5a/K5b: bf16, N > 64): the two-pass tensor-core tile;
      "fma" (K5a/K5b: fp32): the CUDA-core row code. One block per (group
      of `pack` images, head) for K5a, per image for K5b. Only these two
      designs read `pack`; the others leave it at 1.
    Work items are (image, head) pairs in image-major order
    (`attention_item`). `smem` bytes of shared memory a block; vec: 16-byte
    copies and stores, else element loads and stores. `heads_per_pass`:
    the heads a two-pass or fp32 K5b block stages at once, passed to the
    kernel (else 0)."""

    design: str
    items: int
    per_block: int
    blocks: int
    warps: int
    stages: int
    smem: int
    vec: bool
    heads: int
    pack: int = 1
    heads_per_pass: int = 0

    def block_items(self, i: int) -> list[tuple[int, int]]:
        """The (image, head) items block i takes, in order."""
        if self.design == "wgmma":
            return [attention_item(j, self.heads)
                    for j in range(i, self.items, self.blocks)]
        if self.pack > 1 and self.design in ("twopass", "fma"):
            g, h = divmod(i, self.heads)   # one head of a group's images
            return [(g * self.pack + j, h) for j in range(self.pack)]
        return [attention_item(j, self.heads) for j in range(
            i * self.per_block, min((i + 1) * self.per_block, self.items))]


def attention_item(i: int, heads: int) -> tuple[int, int]:
    """Work item i -> (image, head), image-major, as the kernels map it."""
    return divmod(i, heads)


def _onepass_d16(d: int) -> int:
    """16-column k-steps the one-pass tile pads the head dim to."""
    return 2 if d <= 32 else 4 if d <= 64 else 8


def _fp32_layout(n_q: int, N: int, d: int) -> tuple[int, int]:
    """(floats of Q, K and V, floats of one warp's probability rows) of the
    CUDA-core row code's shared memory (attention.cu `layout`)."""
    ld = _round_up(d, 4) | 4
    n4 = _round_up(N, 4)
    return (_round_up(n_q, 4) + 2 * n4) * ld, 4 * n4


def _twopass_tile(M: int, d: int) -> int:
    """bf16 elements of one K (or V) tile of the two-pass tile."""
    return _round_up(M, 16) * (_round_up(d, 16) + 8)


def k5b_pass(N: int, heads: int, d: int, dtype) -> tuple[int, int]:
    """(heads a pass, shared memory bytes) of a two-pass (bf16) or fp32
    K5b block: as many heads as fit `K5_PASS_BUDGET` (two blocks an SM),
    at least one."""
    def pass_bytes(hp):
        if dtype == torch.float32:
            qkv_f, p_f = _fp32_layout(N, N, d)
            return 4 * (hp * qkv_f + K5_WARPS * p_f)
        return 2 * 2 * hp * _twopass_tile(N, d)
    hp = heads
    while hp > 1 and pass_bytes(hp) > K5_PASS_BUDGET:
        hp -= 1
    return hp, pass_bytes(hp)


def tile_scope(B: int, N: int, d: int, dtype, aligned: bool) -> bool:
    """Whether the TMA/wgmma tile takes the shape: bf16, N <= 64, d a
    multiple of 16 up to 128 (whole k-steps of 16; 128-byte rows of one or
    two TMA boxes), 16-byte-aligned input and output (TMA's rule), and row
    and item counts that fit TMA's and the kernel's 32-bit coordinates."""
    return (dtype == torch.bfloat16 and 1 <= N <= TILE_MAX_N
            and d % 16 == 0 and 16 <= d <= MAX_D and aligned
            and B * N < 2**31)


def tile_smem(d: int) -> int:
    """attention.cu `tile_smem_bytes`: the swizzle-alignment slack, the ring
    (Q, K and V of an item, each ceil(d / 64) boxes), the two consumers'
    output tiles, and the ring's and the consumers' mbarriers."""
    d64 = -(-d // 64)
    return 1024 + TILE_STAGES * 3 * d64 * TILE_BOX + 2 * d64 * TILE_BOX \
        + (2 * TILE_STAGES + 2) * 8


def _tile_plan(B, heads, d) -> AttentionPlan:
    """The tile's geometry: one persistent block an SM (`K5_SMS`) while
    there are as many items; a ring of `TILE_STAGES` stages, which fits
    beside the output tiles at every d <= 128."""
    items = B * heads
    blocks = min(K5_SMS, items)
    return AttentionPlan("wgmma", items=items, per_block=-(-items // blocks),
                         blocks=blocks, warps=TILE_THREADS // 32,
                         stages=TILE_STAGES, smem=tile_smem(d), vec=True,
                         heads=heads)


def _onepass_plan(B, N, heads, d, vec) -> AttentionPlan:
    """The one-pass tile's geometry: ceil(N / 16) warps a block, one 16-row
    tile of an item each; runs of items sized so that the grid fills
    `K5_SMS` SMs `K5_BLOCKS_PER_SM` deep; `K5_STAGES` ring stages of one
    item's Q, K and V at a 16-byte-padded pitch."""
    items = B * heads
    per_block = -(-items // (K5_SMS * K5_BLOCKS_PER_SM))
    smem = 2 * K5_STAGES * 3 * _round_up(N, 16) * (_onepass_d16(d) * 16 + 8)
    return AttentionPlan("onepass", items=items, per_block=per_block,
                         blocks=-(-items // per_block), warps=-(-N // 16),
                         stages=K5_STAGES, smem=smem, vec=vec, heads=heads)


@functools.lru_cache(maxsize=256)
def k1_plan(B: int, N: int, heads: int, d: int, dtype,
            aligned: bool = True) -> AttentionPlan:
    """K1's design and geometry at this shape: the TMA/wgmma tile where
    `tile_scope` holds, else the one-pass tile for bf16 at N <= 64, else
    (fp32, bf16 N > 64) the row code, one block of `K1_WARPS` warps per
    (image, head). `aligned`: the input's and output's data pointers are
    16-byte aligned."""
    vec = sixteen_byte_path(d, dtype.itemsize, aligned)
    if tile_scope(B, N, d, dtype, aligned):
        plan = _tile_plan(B, heads, d)
    elif dtype == torch.bfloat16 and N <= K5_ONEPASS_MAX_N:
        plan = _onepass_plan(B, N, heads, d, vec)
    else:
        qkv_f, p_f = _fp32_layout(N, N, d)
        plan = AttentionPlan("rows", items=B * heads, per_block=1,
                             blocks=B * heads, warps=K1_WARPS, stages=1,
                             smem=4 * (qkv_f + K1_WARPS * p_f), vec=vec,
                             heads=heads)
    _check_smem(plan.smem, f"N={N}, d={d} ({dtype}, {plan.design})")
    return plan


@functools.lru_cache(maxsize=256)
def k5_plan(B: int, N: int, heads: int, d: int, dtype, pack: int = 1,
            aligned: bool = True) -> AttentionPlan:
    """K5a's (pack >= 2) or K5b's (pack 1) design and geometry at this
    shape. bf16 at N <= 64 takes K1's kernels with K1's items: the tile
    where `tile_scope` holds, else the one-pass tile. Longer sequences
    take the two-pass tile and fp32 the row code, one block per (group,
    head) (K5a) or per image (K5b), as the first designs launch.
    `aligned`: the input's and output's data pointers are 16-byte
    aligned."""
    if pack < 1 or B % pack:
        raise ValueError(f"pack={pack} must be >= 1 and divide B={B}")
    items = B * heads
    vec = sixteen_byte_path(d, dtype.itemsize, aligned)
    common = dict(items=items, vec=vec, heads=heads, pack=pack)
    if tile_scope(B, N, d, dtype, aligned):
        plan = _tile_plan(B, heads, d)
    elif dtype == torch.bfloat16 and N <= K5_ONEPASS_MAX_N:
        plan = _onepass_plan(B, N, heads, d, vec)
    elif pack > 1:   # one block per (group of pack images, head)
        M = pack * N
        qkv_f, p_f = _fp32_layout(M, M, d)
        smem = 4 * (qkv_f + K5_WARPS * p_f) if dtype == torch.float32 \
            else 2 * 2 * _twopass_tile(M, d)
        plan = AttentionPlan("fma" if dtype == torch.float32 else "twopass",
                             per_block=pack, blocks=items // pack,
                             warps=K5_WARPS, stages=1, smem=smem, **common)
    else:            # one block per image, heads staged in passes
        hp, smem = k5b_pass(N, heads, d, dtype)
        plan = AttentionPlan("fma" if dtype == torch.float32 else "twopass",
                             per_block=heads, blocks=B, warps=K5_WARPS,
                             stages=1, smem=smem, heads_per_pass=hp,
                             **common)
    _check_smem(plan.smem, f"N={N}, d={d}, pack={pack} ({dtype}, "
                f"{plan.design})")
    return plan


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE or t.dtype != dtype:
        raise TypeError(f"{name} must be float32 or bfloat16 (and match the "
                        f"other inputs), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _head_dim(D: int, heads: int, N: int, B: int) -> int:
    if heads < 1 or D % heads:
        raise ValueError(f"width {D} is not divisible by heads={heads}")
    d = D // heads
    if d > MAX_D:
        raise ValueError(f"head dim {d} > {MAX_D} is not supported")
    if N < 1 or B < 1:
        raise ValueError(f"empty input (B={B}, N={N})")
    return d


def _check_smem(smem: int, what: str):
    if smem > MAX_SMEM:
        raise ValueError(f"{what} needs {smem} bytes of shared memory per "
                         f"block, more than {MAX_SMEM}")


def _check_qkv(qkv: torch.Tensor, heads: int) -> tuple[int, int, int, int]:
    """(B, N, D, d) of a contiguous CUDA (B, N, 3D) qkv the kernels take."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(qkv.shape)}")
    B, N, threeD = qkv.shape
    _check("qkv", qkv, qkv.dtype, (B, N, threeD))
    return B, N, threeD // 3, _head_dim(threeD // 3, heads, N, B)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _bf16_softmax() -> int:
    """The libraries' softmax flag for the `SOFTMAX_DTYPE` knob."""
    return int(softmax_dtype() == torch.bfloat16)


def _launch_tile_designs(lib, qkv, out, heads: int, plan,
                         bf16_softmax: int = 0) -> int | None:
    """Launch the design `plan` picked if it is one of the tiles K1, K5a
    and K5b share (their item order is one); None for any other design.
    `bf16_softmax`: the bf16 chain (K1 under `SOFTMAX_DTYPE=bfloat16`)."""
    B, N, threeD = qkv.shape
    d = threeD // (3 * heads)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    if plan.design == "wgmma":
        return lib.lossyless_fused_attention_tile(
            qkv.data_ptr(), out.data_ptr(), B, N, heads, d, d**-0.5,
            plan.blocks, plan.smem, bf16_softmax, qkv.device.index, stream)
    if plan.design == "onepass":
        return lib.lossyless_fused_attention_k5_onepass(
            qkv.data_ptr(), out.data_ptr(), B, N, heads, d, d**-0.5,
            plan.per_block, int(plan.vec), bf16_softmax, qkv.device.index,
            stream)
    return None


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """K1 on the design `k1_plan` picks."""
    B, N, D, d = _check_qkv(qkv, heads)
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    plan = k1_plan(B, N, heads, d, qkv.dtype, _aligned(qkv, out))
    lib = _get_lib()
    sm = _bf16_softmax()
    rc = _launch_tile_designs(lib, qkv, out, heads, plan, sm)
    if rc is None:   # the row code
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.lossyless_fused_attention(
            qkv.data_ptr(), out.data_ptr(), B, N, heads, d,
            _DTYPE_CODE[qkv.dtype], d**-0.5, K1_WARPS, sm,
            qkv.device.index, stream)
    _raise_on(rc, "fused_attention")
    LAUNCHES["fused_attention_bf16_softmax" if sm else "fused_attention"] += 1
    return out


def _launch_k5(qkv: torch.Tensor, heads: int, pack: int) -> torch.Tensor:
    """K5a (pack >= 2) or K5b (pack 1) on the design `k5_plan` picks."""
    B, N, D, d = _check_qkv(qkv, heads)
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    plan = k5_plan(B, N, heads, d, qkv.dtype, pack, _aligned(qkv, out))
    lib = _get_lib()
    dt = _DTYPE_CODE[qkv.dtype]
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = _launch_tile_designs(lib, qkv, out, heads, plan)
    if rc is None and pack > 1:
        rc = lib.lossyless_fused_attention_packed(
            qkv.data_ptr(), out.data_ptr(), B, N, heads, d, pack, dt,
            d**-0.5, K5_WARPS, qkv.device.index, stream)
    elif rc is None:
        rc = lib.lossyless_fused_attention_headbatched(
            qkv.data_ptr(), out.data_ptr(), B, N, heads, d, dt, d**-0.5,
            K5_WARPS, plan.heads_per_pass, qkv.device.index, stream)
    name = "fused_attention_packed" if pack > 1 \
        else "fused_attention_headbatched"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def _launch_attention_packed(qkv: torch.Tensor, heads: int,
                             pack: int) -> torch.Tensor:
    if pack < 2:
        raise ValueError(f"pack={pack} must be >= 2")
    return _launch_k5(qkv, heads, pack)


def _launch_attention_headbatched(qkv: torch.Tensor,
                                  heads: int) -> torch.Tensor:
    return _launch_k5(qkv, heads, 1)


def _launch_attention_cls(q0: torch.Tensor, kv: torch.Tensor,
                          heads: int) -> torch.Tensor:
    if kv.dim() != 3 or kv.shape[-1] % 2:
        raise ValueError(f"kv must be (B, N, 2D), got {tuple(kv.shape)}")
    B, N, twoD = kv.shape
    D = twoD // 2
    _check("kv", kv, kv.dtype, (B, N, twoD))
    _check("q0", q0, kv.dtype, (B, 1, D))
    if q0.device != kv.device:
        raise ValueError(f"q0 on {q0.device} but kv on {kv.device}")
    d = _head_dim(D, heads, N, B)
    out = torch.empty((B, 1, D), dtype=kv.dtype, device=kv.device)
    plan = k2_plan(B, N, heads, d, kv.dtype,
                   all(t.data_ptr() % 16 == 0 for t in (q0, kv, out)))
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    sm = _bf16_softmax()
    rc = _get_lib().lossyless_fused_attention_cls(
        q0.data_ptr(), kv.data_ptr(), out.data_ptr(), B, N, heads, d,
        _DTYPE_CODE[kv.dtype], d**-0.5, plan.warps, int(plan.vec), sm,
        kv.device.index, stream)
    _raise_on(rc, "fused_attention_cls")
    LAUNCHES["fused_attention_cls_bf16_softmax" if sm
             else "fused_attention_cls"] += 1
    return out


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on a "
                     f"CUDA device, got {sorted(devices)}")


def attention_variant(qkv: torch.Tensor) -> tuple[str, int]:
    """("packed", pack), ("headbatched", 1) or ("k1", 1): the variant the
    knobs select for this input, in JAX's order (pack > 1 wins). K5a and
    K5b refuse a bf16 `SOFTMAX_DTYPE` with JAX's error (`:228-234`)."""
    B, N, threeD = qkv.shape
    pack = effective_pack(B, N, threeD, qkv.element_size())
    if (pack > 1 or HEAD_BATCH) and softmax_dtype() != torch.float32:
        raise NotImplementedError(
            "SOFTMAX_DTYPE != float32 is only honored by the per-head and "
            "cls kernels; unset IMAGE_PACK/HEAD_BATCH or keep fp32 softmax")
    if pack > 1:
        return "packed", pack
    return ("headbatched", 1) if HEAD_BATCH else ("k1", 1)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        variant, pack = attention_variant(qkv)
        cpu = _on_cpu(qkv)
        if variant == "packed":
            return attention_packed_plain(qkv, heads, pack) if cpu \
                else _launch_attention_packed(qkv, heads, pack)
        if variant == "headbatched":
            return attention_headbatched_plain(qkv, heads) if cpu \
                else _launch_attention_headbatched(qkv, heads)
        if cpu:
            return attention_plain(qkv, heads)
        return _launch_attention(qkv, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            t = qkv.detach().requires_grad_()
            # fp32 softmax whatever the knob, as JAX's backward recomputes
            # through `_reference_attention`
            (dqkv,) = torch.autograd.grad(
                attention_plain(t, ctx.heads, torch.float32), t, g)
        return dqkv, None


class _FusedAttentionCls(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q0, kv, heads):
        ctx.heads = heads
        ctx.save_for_backward(q0, kv)
        if _on_cpu(q0, kv):
            return attention_cls_plain(q0, kv, heads)
        return _launch_attention_cls(q0, kv, heads)

    @staticmethod
    def backward(ctx, g):
        q0, kv = ctx.saved_tensors
        with torch.enable_grad():
            tq = q0.detach().requires_grad_()
            tkv = kv.detach().requires_grad_()
            out = attention_cls_plain(tq, tkv, ctx.heads, torch.float32)
            dq, dkv = torch.autograd.grad(out, (tq, tkv), g)
        return dq, dkv, None


def fused_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused MHSA from a (B, N, 3D) qkv tensor -> (B, N, D): K1, or K5a /
    K5b when `IMAGE_PACK` / `HEAD_BATCH` select them."""
    return _FusedAttention.apply(qkv, heads)


def fused_attention_cls(q0: torch.Tensor, kv: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """K2: fused MHSA for token-0 queries: (B,1,D) q, (B,N,2D) kv -> (B,1,D)."""
    return _FusedAttentionCls.apply(q0, kv, heads)


# ---------------------------------------------------------------------------
# K4: the fused MLP half-block x + proj(QuickGELU(fc(LN(x))))
# ---------------------------------------------------------------------------

_mlp_lib = None


def _get_mlp_lib():
    global _mlp_lib
    if _mlp_lib is None:
        with _lib_lock:
            if _mlp_lib is None:
                from . import _build

                lib = _build.load("mlp_block")
                i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
                lib.lossyless_mlp_block_smem_bytes.restype = ctypes.c_size_t
                lib.lossyless_mlp_block_smem_bytes.argtypes = [i]
                lib.lossyless_fused_mlp_block.restype = i
                lib.lossyless_fused_mlp_block.argtypes = [
                    p, p, p, p, p, p, p, p, i, i, i, f, i, p]
                lib.lossyless_mlp_block_tile_smem_bytes.restype = \
                    ctypes.c_size_t
                lib.lossyless_mlp_block_tile_smem_bytes.argtypes = [i, i]
                lib.lossyless_fused_mlp_block_tile.restype = i
                lib.lossyless_fused_mlp_block_tile.argtypes = [
                    p, p, p, p, p, p, p, p, p, p, i, i, i, f, p, p, i, p]
                _mlp_lib = lib
    return _mlp_lib


def mlp_block_plain(x, ln_scale, ln_bias, fc_w, fc_b, pr_w, pr_b,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain K4, in the kernel's order and rounding points
    (`_mlp_kernel`): fp32 LayerNorm statistics, y cast to the io dtype,
    each dot accumulated in fp32 then cast, bias adds and QuickGELU
    `h * (1 / (1 + exp(-1.702 h)))` in the io dtype (the constant too)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(dt)
    h = torch.matmul(y.float(), fc_w.to(dt).float()).to(dt) + fc_b.to(dt)
    h = quick_gelu_plain(h)
    o = torch.matmul(h.float(), pr_w.to(dt).float()).to(dt) + pr_b.to(dt)
    return x + o


def quick_gelu_plain(h: torch.Tensor) -> torch.Tensor:
    """`h * (1 / (1 + exp(-1.702 h)))` in h's dtype, every operation (and
    the constant) rounded to it, as `_mlp_kernel` computes it."""
    one = torch.ones((), dtype=h.dtype, device=h.device)
    k = torch.full((), -1.702, dtype=h.dtype, device=h.device)
    return h * (one / (one + torch.exp(k * h)))


# K4's plan. The mma.sync design's limits mirror mlp_block.cu's kMaxD and
# kChunk; the wgmma design's constants its kTileM, kTileK and tile_smem_bytes.
K4_MMA_MAX_D = 768         # mma.sync design: D <= this (its accumulator)
K4_MMA_CHUNK = 32          # mma.sync design: H a multiple of this
K4_MMA_ROWS = 32           # mma.sync design: token rows a block
K4_TILE_M = 128            # wgmma design: output rows a block
K4_TILE_K = 64             # wgmma design: a k-step (one 128-byte row)
K4_MAX_STAGES = 8          # wgmma design: ring stages at most


@dataclass(frozen=True)
class K4Product:
    """One wgmma product of K4, (M, K) . (K, N): 128 x `n_tile` output
    tiles, `grid` = (column tiles, row tiles), taken by `blocks`
    persistent blocks (one an SM) in turn; a ring of `stages` k-steps of
    64 and `smem` bytes of shared memory a block."""

    n_tile: int
    grid: tuple[int, int]
    blocks: int
    stages: int
    smem: int

    def args(self):
        """The four ints the library takes for a product."""
        return (ctypes.c_int * 4)(self.n_tile, self.stages, self.blocks,
                                  self.smem)


@dataclass(frozen=True)
class K4Plan:
    """The design and geometry of one K4 call at (M, D, H).

    design "wgmma": three kernels, the LayerNorm pass, the fc product
    `fc` (N = H, K = D) and the proj product `proj` (N = D, K = H);
    `smem` is the larger product's.
    design "mma_sync": the one-kernel design, `blocks` blocks of
    `K4_MMA_ROWS` rows with `smem` bytes each."""

    design: str
    smem: int
    blocks: int = 0
    fc: K4Product | None = None
    proj: K4Product | None = None


def _k4_tile_smem(n_tile: int, stages: int) -> int:
    """mlp_block.cu `tile_smem_bytes`: the swizzle-alignment slack, the
    ring (an A tile of 128 x 64 and n_tile / 64 B boxes of 64 x 64, bf16),
    the two consumers' epilogue tiles (128 rows of n_tile + 8 bf16) and
    the ring's and the consumers' mbarriers."""
    return 1024 + stages * (2 * K4_TILE_M * K4_TILE_K
                            + 2 * n_tile * K4_TILE_K) \
        + 2 * K4_TILE_M * (n_tile + 8) * 2 + (stages + 1) * 16


def _k4_mma_smem(D: int) -> int:
    """mlp_block.cu `layout(D).total` in bytes."""
    d16 = _round_up(D, 16)
    pitch = K4_MMA_CHUNK + 8
    return 2 * (K4_MMA_ROWS * (d16 + 8) + d16 * pitch
                + K4_MMA_CHUNK * (D + 8) + K4_MMA_ROWS * pitch)


def _k4_product(M: int, N: int) -> K4Product:
    """The product's tiles: 128 columns where they divide N, else 64 (a
    narrower tile reads its A operand from shared memory for too few
    columns to keep the tensor cores fed; a wider one's accumulator, both
    64-row halves of a tile in one consumer, would not fit the registers).
    One persistent block an SM (`K5_SMS`) while there are as many tiles;
    the ring takes as many stages as fit beside the epilogue tiles."""
    n_tile = 128 if N % 128 == 0 else 64
    grid = (N // n_tile, -(-M // K4_TILE_M))
    stages = 2
    while stages < K4_MAX_STAGES \
            and _k4_tile_smem(n_tile, stages + 1) <= MAX_SMEM:
        stages += 1
    return K4Product(n_tile, grid, min(K5_SMS, grid[0] * grid[1]), stages,
                     _k4_tile_smem(n_tile, stages))


@functools.lru_cache(maxsize=256)
def k4_plan(M: int, D: int, H: int) -> K4Plan:
    """K4's design at M token rows of width D with hidden width H.

    "wgmma" where D and H are multiples of 64 (whole 64-wide k-steps and
    output tiles; TMA pads a ragged M with zeros), else "mma_sync" where
    D <= K4_MMA_MAX_D and H is a multiple of K4_MMA_CHUNK; any other shape
    raises, naming both rules. D and H must be multiples of 8 either way
    (16-byte rows: TMA's stride rule and the 16-byte loads)."""
    if M < 1:
        raise ValueError(f"empty input (M={M})")
    if D % 8 or H % 8 or D < 8 or H < 8:
        raise ValueError(f"D={D} and H={H} must be multiples of 8 "
                         f"(16-byte rows)")
    if D % K4_TILE_K == 0 and H % K4_TILE_K == 0:
        fc, proj = _k4_product(M, H), _k4_product(M, D)
        plan = K4Plan("wgmma", smem=max(fc.smem, proj.smem), fc=fc,
                      proj=proj)
    elif D <= K4_MMA_MAX_D and H % K4_MMA_CHUNK == 0:
        plan = K4Plan("mma_sync", smem=_k4_mma_smem(D),
                      blocks=-(-M // K4_MMA_ROWS))
    else:
        raise ValueError(
            f"no K4 design takes D={D}, H={H}: the wgmma design needs D and "
            f"H multiples of {K4_TILE_K}, the mma.sync design D <= "
            f"{K4_MMA_MAX_D} and H a multiple of {K4_MMA_CHUNK}")
    _check_smem(plan.smem, f"K4 at M={M}, D={D}, H={H} ({plan.design})")
    return plan


def _launch_mlp_block(x, ln_scale, ln_bias, fc_w, fc_b, pr_w, pr_b,
                      eps: float) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused MLP kernel takes bfloat16 activations "
                        f"(its products run on bf16 tensor cores), got "
                        f"{x.dtype}; use mlp_impl='ops' for {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"x must be (..., D), got {tuple(x.shape)}")
    D = x.shape[-1]
    if fc_w.dim() != 2 or fc_w.shape[0] != D:
        raise ValueError(f"fc_w must be (D={D}, H), got {tuple(fc_w.shape)}")
    H = fc_w.shape[1]
    M = x.numel() // D
    plan = k4_plan(M, D, H)
    bf16 = torch.bfloat16
    x2 = x.reshape(M, D).contiguous()
    args = [x2, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            fc_w.to(bf16).contiguous(), fc_b.to(bf16).contiguous(),
            pr_w.to(bf16).contiguous(), pr_b.to(bf16).contiguous()]
    shapes = [(M, D), (D,), (D,), (D, H), (H,), (H, D), (D,)]
    names = ["x", "ln_scale", "ln_bias", "fc_w", "fc_b", "pr_w", "pr_b"]
    for name, t, shape in zip(names, args, shapes):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x2)
    lib = _get_mlp_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in args]
    if plan.design == "wgmma":
        y = torch.empty((M, D), dtype=bf16, device=x.device)
        hidden = torch.empty((M, H), dtype=bf16, device=x.device)
        rc = lib.lossyless_fused_mlp_block_tile(
            *ptrs, y.data_ptr(), hidden.data_ptr(), out.data_ptr(), M, D, H,
            eps, plan.fc.args(), plan.proj.args(), x.device.index, stream)
    else:
        rc = lib.lossyless_fused_mlp_block(
            *ptrs, out.data_ptr(), M, D, H, eps, x.device.index, stream)
    _raise_on(rc, "fused_mlp_block")
    LAUNCHES["fused_mlp_block"] += 1
    return out.reshape(x.shape)


class _FusedMlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lns, lnb, fcw, fcb, prw, prb, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, lns, lnb, fcw, fcb, prw, prb)
        if _on_cpu(x, lns, lnb, fcw, fcb, prw, prb):
            return mlp_block_plain(x, lns, lnb, fcw, fcb, prw, prb, eps)
        return _launch_mlp_block(x, lns, lnb, fcw, fcb, prw, prb, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ts = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
            out = mlp_block_plain(*ts, ctx.eps)
            inputs = [t for t in ts if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, g)
                         if inputs else ())
        return (*(next(grads) if t.requires_grad else None for t in ts),
                None)


def fused_mlp_block(x, ln_scale, ln_bias, fc_w, fc_b, pr_w, pr_b,
                    eps: float = 1e-5) -> torch.Tensor:
    """K4: `x + proj(QuickGELU(fc(LayerNorm(x))))` as one kernel.

    x (..., D); fc_w (D, H), fc_b (H,), pr_w (H, D), pr_b (D,), LayerNorm
    scale/bias (D,). Weights are used in x's dtype. The backward
    recomputes through `mlp_block_plain`.
    """
    return _FusedMlpBlock.apply(x, ln_scale, ln_bias, fc_w, fc_b, pr_w,
                                pr_b, eps)
