"""Fused multi-head attention for short token sequences (CUDA, Hopper).

Counterpart of the Pallas kernels in `lossyless_tpu/nn/flash_attn.py`:

* K1 `fused_attention(qkv, heads)` — MHSA straight off the fused qkv
  projection in its natural (B, N, 3D) layout, out (B, N, D). Replaces
  `fused_attention` / `_attn_kernel`. Runs the attention of CLIP ViT
  blocks 0..L-2.
* K2 `fused_attention_cls(q0, kv, heads)` — the class-token query only:
  q0 (B, 1, D), kv (B, N, 2D), out (B, 1, D). Replaces
  `fused_attention_cls` / `_attn_cls_kernel`. Runs the last ViT block.

Both kernels are CUDA C++ in `csrc/attention.cu` (design and bounds noted
there), built with nvcc at first use (`_build.py`) and called through
ctypes on PyTorch's current stream. Each wrapper checks device, dtype,
shape and contiguity, allocates the output, launches, raises if the launch
returned a CUDA error, and adds one to its entry of `LAUNCHES`.

A CPU tensor goes to the plain version (`attention_plain`,
`attention_cls_plain`: plain torch with the kernel's arithmetic). A CUDA
tensor goes to the kernel or the call raises; nothing falls back. The
backward of both recomputes through the plain version, as the JAX
`custom_vjp`s do.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# launches of each kernel, counted where the kernel is launched and nowhere
# else (a run reads them to show its main path went through the kernels)
LAUNCHES = {"fused_attention": 0, "fused_attention_cls": 0}

MAX_D = 128
MAX_SMEM = 232448          # bytes of shared memory a Hopper block can use
K1_WARPS = 8               # warps per (image, head) block; each takes rows
K2_WARPS = 4               # one query row: warp 0 computes, all stage K/V
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
                    p, p, i, i, i, i, i, f, i, i, p]
                lib.lossyless_fused_attention_cls.restype = i
                lib.lossyless_fused_attention_cls.argtypes = [
                    p, p, p, i, i, i, i, i, f, i, i, p]
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


def attention_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain K1: (B, N, 3D) -> (B, N, D).

    q.k accumulates in fp32 and is scaled by d^-1/2 after the dot; softmax
    in fp32; probabilities cast to the io dtype before an fp32 P.V.
    """
    B, N, threeD = qkv.shape
    D = threeD // 3
    d = D // heads
    q, k, v = qkv.float().split(D, dim=-1)
    q = q.reshape(B, N, heads, d)
    k = k.reshape(B, N, heads, d)
    v = v.reshape(B, N, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    attn = _softmax_to(logits, qkv.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, N, D).to(qkv.dtype)


def attention_cls_plain(q0: torch.Tensor, kv: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Plain K2: q0 (B, 1, D), kv (B, N, 2D) -> (B, 1, D)."""
    B, N, twoD = kv.shape
    D = twoD // 2
    d = D // heads
    k, v = kv.float().split(D, dim=-1)
    q = q0.float().reshape(B, 1, heads, d)
    k = k.reshape(B, N, heads, d)
    v = v.reshape(B, N, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    attn = _softmax_to(logits, kv.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return out.reshape(B, 1, D).to(kv.dtype)


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


def _head_dim(D: int, heads: int, n_q: int, N: int, B: int,
              warps: int) -> int:
    if heads < 1 or D % heads:
        raise ValueError(f"width {D} is not divisible by heads={heads}")
    d = D // heads
    if d > MAX_D:
        raise ValueError(f"head dim {d} > {MAX_D} is not supported")
    if N < 1 or B < 1:
        raise ValueError(f"empty input (B={B}, N={N})")
    smem = _get_lib().lossyless_attention_smem_bytes(n_q, N, d, warps)
    if smem > MAX_SMEM:
        raise ValueError(f"N={N}, d={d} needs {smem} bytes of shared memory "
                         f"per block, more than {MAX_SMEM}")
    return d


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(qkv.shape)}")
    B, N, threeD = qkv.shape
    D = threeD // 3
    _check("qkv", qkv, qkv.dtype, (B, N, threeD))
    d = _head_dim(D, heads, N, N, B, K1_WARPS)
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = _get_lib().lossyless_fused_attention(
        qkv.data_ptr(), out.data_ptr(), B, N, heads, d,
        _DTYPE_CODE[qkv.dtype], d**-0.5, K1_WARPS, qkv.device.index, stream)
    _raise_on(rc, "fused_attention")
    LAUNCHES["fused_attention"] += 1
    return out


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
    d = _head_dim(D, heads, 1, N, B, K2_WARPS)
    out = torch.empty((B, 1, D), dtype=kv.dtype, device=kv.device)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    rc = _get_lib().lossyless_fused_attention_cls(
        q0.data_ptr(), kv.data_ptr(), out.data_ptr(), B, N, heads, d,
        _DTYPE_CODE[kv.dtype], d**-0.5, K2_WARPS, kv.device.index, stream)
    _raise_on(rc, "fused_attention_cls")
    LAUNCHES["fused_attention_cls"] += 1
    return out


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"attention inputs must all be on the CPU or all on a "
                     f"CUDA device, got {sorted(devices)}")


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        if _on_cpu(qkv):
            return attention_plain(qkv, heads)
        return _launch_attention(qkv, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            t = qkv.detach().requires_grad_()
            (dqkv,) = torch.autograd.grad(attention_plain(t, ctx.heads), t, g)
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
            out = attention_cls_plain(tq, tkv, ctx.heads)
            dq, dkv = torch.autograd.grad(out, (tq, tkv), g)
        return dq, dkv, None


def fused_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """K1: fused MHSA from a (B, N, 3D) qkv tensor -> (B, N, D)."""
    return _FusedAttention.apply(qkv, heads)


def fused_attention_cls(q0: torch.Tensor, kv: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """K2: fused MHSA for token-0 queries: (B,1,D) q, (B,N,2D) kv -> (B,1,D)."""
    return _FusedAttentionCls.apply(q0, kv, heads)
