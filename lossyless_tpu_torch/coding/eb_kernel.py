"""Fused factorized-prior likelihood (CUDA, Hopper): kernel K3.

Counterpart of `lossyless_tpu/coding/pallas_eb.py`. `likelihood(params, z)`
returns the entropy bottleneck's likelihood of `z` (batch, channels),
floored at `LIKELIHOOD_BOUND` inside the kernel, as `pallas_eb.likelihood`
does. The kernel is CUDA C++ in `csrc/eb_likelihood.cu` (design and bound
noted there), built with nvcc at first use (`nn/_build.py`) and called
through ctypes on PyTorch's current stream. The wrapper checks device,
dtype, shape and the filter tuple, packs the per-channel coefficients into
one (C, K) tensor, launches, raises if the launch returned a CUDA error,
and adds one to `LAUNCHES`.

A CPU tensor goes to the plain version (`likelihood_plain`: the port's
`entropy_bottleneck.likelihood` floored with `clamp_min`). A CUDA tensor
goes to the kernel or the call raises. The backward recomputes through the
reference chain with `lower_bound` semantics and the sign detached, as the
JAX `custom_vjp` does (`pallas_eb.py:153-171`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.math import lower_bound
from . import entropy_bottleneck as eb

LAUNCHES = {"eb_likelihood": 0}

_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from ..nn import _build

                lib = _build.load("eb_likelihood")
                i, p = ctypes.c_int, ctypes.c_void_p
                lib.lossyless_eb_smem_bytes.restype = ctypes.c_size_t
                lib.lossyless_eb_smem_bytes.argtypes = [i]
                lib.lossyless_eb_max_width.restype = i
                lib.lossyless_eb_max_layers.restype = i
                lib.lossyless_eb_likelihood.restype = i
                lib.lossyless_eb_likelihood.argtypes = [
                    p, p, p, i, i, i, ctypes.POINTER(i), i, p]
                _lib = lib
    return _lib


def likelihood_plain(params: dict, z: torch.Tensor) -> torch.Tensor:
    """Plain K3: the reference chain, floored at the bound (the kernel's
    forward arithmetic, `pallas_eb.py:99-103`)."""
    return eb.likelihood(params, z).clamp_min(eb.LIKELIHOOD_BOUND)


def widths(params: dict) -> tuple[int, ...]:
    """(1, filters..., 1) of an entropy-bottleneck param dict."""
    L = eb.n_layers(params)
    return (1,) + tuple(params[f"matrix{i}"].shape[1] for i in range(L))


def pack_coefficients(params: dict) -> torch.Tensor:
    """(C, K) fp32: per layer the matrix (out x in), the bias and, for all
    but the last layer, the factor — the order the kernel reads them."""
    L = eb.n_layers(params)
    C = params["matrix0"].shape[0]
    parts = []
    for i in range(L):
        parts += [params[f"matrix{i}"], params[f"bias{i}"]]
        if i < L - 1:
            parts.append(params[f"factor{i}"])
    return torch.cat([p.reshape(C, -1).float() for p in parts], dim=1) \
        .contiguous()


def _launch(params: dict, z: torch.Tensor) -> torch.Tensor:
    if z.device.type != "cuda":
        raise ValueError(f"z must be a CUDA tensor, got {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"z must be float32, got {z.dtype}")
    if z.dim() != 2 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (batch, channels) tensor, "
                         f"got shape {tuple(z.shape)}")
    B, C = z.shape
    w = widths(params)
    lib = _get_lib()
    if B < 1 or C < 1:
        raise ValueError(f"empty input (B={B}, C={C})")
    if B > 65535 * 4:
        raise ValueError(f"batch {B} exceeds the kernel's grid")
    if len(w) - 1 > lib.lossyless_eb_max_layers() \
            or max(w) > lib.lossyless_eb_max_width():
        raise ValueError(f"filter widths {w[1:-1]} exceed the kernel's "
                         f"{lib.lossyless_eb_max_width()} filters x "
                         f"{lib.lossyless_eb_max_layers()} layers")
    coeffs = pack_coefficients(params)
    if coeffs.shape[0] != C or coeffs.device != z.device:
        raise ValueError(f"params hold {coeffs.shape[0]} channels on "
                         f"{coeffs.device}, z has {C} on {z.device}")
    if lib.lossyless_eb_smem_bytes(coeffs.shape[1]) > 48 * 1024:
        raise ValueError(f"{coeffs.shape[1]} coefficients per channel need "
                         f"more than 48 KB of shared memory per block")
    out = torch.empty_like(z)
    dims = (ctypes.c_int * len(w))(*w)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = lib.lossyless_eb_likelihood(
        z.data_ptr(), coeffs.data_ptr(), out.data_ptr(), B, C, len(w) - 1,
        dims, z.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"eb_likelihood kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["eb_likelihood"] += 1
    return out


def _reference(params: dict, z: torch.Tensor) -> torch.Tensor:
    # eb.likelihood detaches the sign; lower_bound (not clamp) keeps the
    # recover-direction gradient of floored likelihoods
    return lower_bound(eb.likelihood(params, z), eb.LIKELIHOOD_BOUND)


class _EBLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, keys, *values):
        params = dict(zip(keys, values))
        ctx.keys = keys
        ctx.save_for_backward(z, *values)
        if z.device.type == "cpu":
            return likelihood_plain(params, z)
        return _launch(params, z.contiguous())

    @staticmethod
    def backward(ctx, g):
        z, *values = ctx.saved_tensors
        with torch.enable_grad():
            tz = z.detach().requires_grad_(ctx.needs_input_grad[0])
            tv = [v.detach().requires_grad_(ctx.needs_input_grad[i + 2])
                  for i, v in enumerate(values)]
            inputs = [t for t in [tz, *tv] if t.requires_grad]
            lik = _reference(dict(zip(ctx.keys, tv)), tz)
            grads = iter(torch.autograd.grad(lik, inputs, g)
                         if inputs else ())
        out_z = next(grads) if tz.requires_grad else None
        out_v = [next(grads) if t.requires_grad else None for t in tv]
        return (out_z, None, *out_v)


def likelihood(params: dict, z: torch.Tensor) -> torch.Tensor:
    """K3: likelihood of z (batch, channels) fp32, floored at the bound.

    Only the chain's params (`matrix*`, `bias*`, `factor*`) take part;
    `quantiles` does not enter the likelihood.
    """
    keys = tuple(k for k in params if k != "quantiles")
    devices = {z.device.type} | {params[k].device.type for k in keys}
    if len(devices) != 1:
        raise ValueError(f"z and params must all be on the CPU or all on a "
                         f"CUDA device, got {sorted(devices)}")
    return _EBLikelihood.apply(z.float(), keys, *(params[k] for k in keys))
