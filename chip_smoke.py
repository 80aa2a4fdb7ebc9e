#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`lossyless_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build of every native library of the main path from the sources in the
   checkout (the attention kernels with nvcc, the rANS codec with g++, in
   parallel), with nvcc's register/shared-memory report;
3. each attention kernel against its plain PyTorch version on the card, at
   the slice shapes (ViT-B/32: N=50, 12 heads of 64, bf16, batch 512 and the
   main path's 256), at odd shapes in fp32 and, for K2, the RN50
   attention-pool shape; then CUDA-event timings of the kernel, its plain
   version and `scaled_dot_product_attention` (timed as a yardstick only);
4. the main path at full width: a seeded random CLIP ViT-B/32 tower in bf16
   with seeded entropy-bottleneck params, `compress_dataset` over 8 batches
   of 256 raw uint8 96x96 images, then `decompress_dataset`. The decoded
   features must equal the dequantize path to 1e-5, the launch counters must
   read 11 x K1 and 1 x K2 per batch, and a re-encode with the attention on
   the plain versions must flip at most 1% of the symbols; then a
   torch.profiler trace of 4 encode batches gives the device time by kernel
   group and the device idle share;
5. the `kernels` JSON line and, last, `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository around it: with no card, or run
from a directory that holds only this file, it fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM data sheet: HBM rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

N_BATCHES, BATCH, RAW_HW = 8, 256, (96, 96)
SLICE = dict(N=50, heads=12, d=64)   # ViT-B/32 attention shapes


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, warmup: int = 5, runs: int = 25, reps: int = 10) -> float:
    """Median over `runs` of the per-call device time of `reps` calls
    enqueued back to back between two CUDA events (so the host's launch
    overhead hides behind the queue instead of inflating the time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_inputs(B, N, heads, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, N, 3 * heads * d, generator=g, device="cuda")
            .to(dtype),)


def k2_inputs(B, N, heads, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    D = heads * d
    q0 = torch.randn(B, 1, D, generator=g, device="cuda").to(dtype)
    kv = torch.randn(B, N, 2 * D, generator=g, device="cuda").to(dtype)
    return q0, kv


def check_kernels():
    """Phase 3: kernels vs plain versions, then timings at batch 512."""
    import torch
    import torch.nn.functional as F

    from lossyless_tpu_torch.nn import flash_attn as fa

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "fused_attention": (k1_inputs, fa.fused_attention,
                            fa.attention_plain, [
                                (512, 50, 12, 64, bf16, 2e-2),
                                (BATCH, 50, 12, 64, bf16, 2e-2),
                                (1, 5, 12, 64, f32, 1e-5),
                                (3, 7, 12, 64, f32, 1e-5),
                                (3, 5, 4, 24, f32, 1e-5),
                                (1, 7, 2, 128, f32, 1e-5),
                                (2, 9, 2, 33, f32, 1e-5),     # scalar staging
                                (3, 7, 3, 20, bf16, 2e-2),    # scalar staging
                                (4, 197, 12, 64, bf16, 2e-2),  # >48 KB smem
                            ]),
        "fused_attention_cls": (k2_inputs, fa.fused_attention_cls,
                                fa.attention_cls_plain, [
                                    (512, 50, 12, 64, bf16, 2e-2),
                                    (BATCH, 50, 12, 64, bf16, 2e-2),
                                    (1, 5, 12, 64, f32, 1e-5),
                                    (3, 7, 12, 64, f32, 1e-5),
                                    (64, 50, 32, 64, f32, 1e-5),  # RN50 pool
                                ]),
    }
    results = {}
    with torch.inference_mode():
        for name, (make, kernel, plain, shapes) in cases.items():
            errs = []
            for i, (B, N, h, d, dtype, tol) in enumerate(shapes):
                args = make(B, N, h, d, dtype, seed=i)
                got = kernel(*args, h)
                torch.cuda.synchronize()
                want = plain(*args, h)
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= tol
                print(f"check {name} B={B} N={N} h={h} d={d} "
                      f"{str(dtype)[6:]}: max_abs_err={err!r} tol={tol} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at B={B} N={N}")
                errs.append(err)

            B, N, h, d = 512, SLICE["N"], SLICE["heads"], SLICE["d"]
            args = make(B, N, h, d, bf16, seed=100)
            D = h * d
            if name == "fused_attention":
                (qkv,) = args
                q, k, v = (t.view(B, N, h, d).transpose(1, 2)
                           for t in qkv.split(D, dim=-1))
                nbytes = qkv.numel() * 2 + B * N * D * 2
                flops = 4 * B * h * N * N * d
            else:
                q0, kv = args
                q = q0.view(B, 1, h, d).transpose(1, 2)
                k, v = (t.view(B, N, h, d).transpose(1, 2)
                        for t in kv.split(D, dim=-1))
                nbytes = q0.numel() * 2 + kv.numel() * 2 + B * D * 2
                flops = 4 * B * h * N * d
            ms = median_ms(lambda: kernel(*args, h))
            plain_ms = median_ms(lambda: plain(*args, h))
            library_ms = median_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))
            bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
            results[name] = dict(max_abs_err=errs[0], ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms)
            print(f"time {name} B={B} N={N} h={h} d={d} bf16: kernel "
                  f"{ms!r} ms, plain {plain_ms!r} ms, sdpa {library_ms!r} "
                  f"ms, bound {bound_ms!r} ms ({bound_by}: {nbytes} bytes, "
                  f"{flops} flop)", flush=True)
    return results


def main_path(card: str) -> dict:
    """Phase 4: compress_dataset + decompress_dataset at full width."""
    import torch

    from lossyless_tpu_torch.coding import entropy_bottleneck as eb
    from lossyless_tpu_torch.coding import rans
    from lossyless_tpu_torch.hub.compressor import ClipCompressor
    from lossyless_tpu_torch.nn import _build
    from lossyless_tpu_torch.nn import flash_attn as fa
    from lossyless_tpu_torch.nn.vit import vit_b32

    rng = np.random.default_rng(0)
    eb_params = eb.init_params(eb.EBConfig(512),
                               torch.Generator().manual_seed(0))
    scaling = rng.normal(1.5, 0.2, 512).astype(np.float32)
    biasing = rng.normal(0.0, 0.1, 512).astype(np.float32)
    images = rng.integers(0, 256, (N_BATCHES * BATCH, *RAW_HW, 3),
                          dtype=np.uint8)
    batches = [(images[i * BATCH:(i + 1) * BATCH],
                np.arange(i * BATCH, (i + 1) * BATCH))
               for i in range(N_BATCHES)]

    comp = ClipCompressor(eb_params, scaling, biasing, raw_input_hw=RAW_HW)
    comp.compress(batches[0][0])            # tower init + warm-up
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        data, labels = Path(tmp) / "z.bin", Path(tmp) / "y.npy"
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        rate, _ = comp.compress_dataset(iter(batches), data, labels,
                                        is_info=False)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        z_hat, y = comp.decompress_dataset(data, labels, is_info=False)
        t_dec = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)

    n_layers = len(comp.model.blocks)
    want = {"fused_attention": (n_layers - 1) * N_BATCHES,
            "fused_attention_cls": N_BATCHES}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if rans._get_lib()._name != str(_build.library_path("rans")):
        raise AssertionError("the rANS codec is not the native build")

    n = len(images)
    if z_hat.shape != (n, 512) or not np.isfinite(z_hat).all():
        raise AssertionError(f"decoded features: shape {z_hat.shape}, "
                             f"finite {np.isfinite(z_hat).all()}")
    np.testing.assert_array_equal(y, np.arange(n))
    features = np.concatenate([comp(x) for x, _ in batches])
    dec_err = float(np.abs(z_hat - features).max())
    print(f"decode vs dequantize path: max_abs_err={dec_err!r}", flush=True)
    if dec_err > 1e-5:
        raise AssertionError(f"decode round-trip off by {dec_err}")

    # the same tower with attention on the plain versions
    plain = ClipCompressor(eb_params, scaling, biasing,
                           clip_params=comp.model.state_dict(),
                           model=vit_b32(attn_impl="plain"),
                           raw_input_hw=RAW_HW)
    x0 = batches[0][0]
    s_kernel = comp.codec.decode_batch(comp.compress(x0), comp.indexes)
    s_plain = plain.codec.decode_batch(plain.compress(x0), plain.indexes)
    flips = int((s_kernel != s_plain).sum())
    flip_frac = flips / s_kernel.size
    print(f"symbol flips kernel vs plain attention: {flips} of "
          f"{s_kernel.size} ({flip_frac!r})", flush=True)
    if flip_frac > 0.01:
        raise AssertionError(f"{flip_frac:.4f} of symbols flip")

    result = dict(card=card, images=n, batch=BATCH, raw_hw=list(RAW_HW),
                  encode_img_per_s=n / t_enc, decode_img_per_s=n / t_dec,
                  bits_per_img=rate, symbol_flip_fraction=flip_frac,
                  decode_max_abs_err=dec_err)
    print(json.dumps({"main_path": result}), flush=True)
    profile_encode(comp, batches[:4], card)
    return launches


def profile_encode(comp, batches, card: str):
    """Phase 4b: where the encode time goes, from a torch.profiler trace of
    `compress_dataset` over a few batches (after the timed run, so the
    profiler's cost is not in the img/s above)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        comp.compress_dataset(iter(batches), Path(tmp) / "p.bin",
                              is_info=False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    busy_ms = sum(by_name.values())
    groups = {"attention K1/K2": ("attention_kernel",),
              "matmul": ("gemm", "xmma", "cutlass", "nvjet", "cublas"),
              "copies": ("memcpy", "memset")}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for name, ms in by_name.items():
        group = next((g for g, keys in groups.items()
                      if any(k in name.lower() for k in keys)), "other")
        by_group[group] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"profile": dict(
        card=card, images=sum(len(x) for x, _ in batches), wall_ms=wall_ms,
        device_busy_ms=busy_ms if busy_ms else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if busy_ms else
        "not measured", by_group_ms=by_group,
        top_kernels_ms=[[name[:80], ms] for name, ms in top])}),
        flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from lossyless_tpu_torch.nn import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {seconds} (wall {time.perf_counter() - t0:.1f} s)",
          flush=True)
    for line in _build.build_log("attention").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    timings = check_kernels()
    launches = main_path(card)

    replaces = {"fused_attention": "lossyless_tpu/nn/flash_attn.py:211",
                "fused_attention_cls": "lossyless_tpu/nn/flash_attn.py:349"}
    kernels = [dict(name=name, route="cuda",
                    source="lossyless_tpu_torch/nn/csrc/attention.cu",
                    replaces=replaces[name], launches=launches[name],
                    launches_per_batch=launches[name] / N_BATCHES,
                    **timings[name])
               for name in ("fused_attention", "fused_attention_cls")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
