"""Benchmark: STL10-shaped encode throughput of the CLIP compressor on one
CUDA card.

    python -m lossyless_tpu_torch.bench               # device-resident
    python -m lossyless_tpu_torch.bench --host-fed    # compress_dataset
    python -m lossyless_tpu_torch.bench --folder-fed  # JPEG folder (PIL)
    python -m lossyless_tpu_torch.bench --softmax-dtype bfloat16  # knobs

Counterpart of the JAX package's root `bench.py`, with its protocol and
its JSON keys where they mean the same thing on this card. It prints the
card's name and power limit on a line of its own, then ONE JSON line.

* default: `BENCH_N_BATCHES` x `BENCH_BATCH` (32 x 512) uint8 224x224
  images made on the card from a seeded `torch.Generator` (~2.47 GB).
  A window encodes them all: XOR with a salt (each run encodes new bits),
  the normalize folded into one bf16 multiply-add, then the symbols of a
  `ClipCompressor` (its `_encode_symbols`: ViT-B/32 in bf16 on K1/K2, the
  per-dim affine, rounding), narrowed to int8 with an overflow count; the
  compressor's `_start_readback` copies them to pinned host memory and its
  codec codes them on a host thread while the card runs the next window.
  Protocol: one warm window, then `BENCH_RUNS` (3) runs of 8 windows kept
  two in flight, every dispatched window consumed; a run's rate is the
  interquartile mean of the gaps between window completions, the headline
  the median of the runs; `whole_run_img_per_sec` is every image of a run
  over all of its time (median of the runs), stalls included.
  `device_capacity_img_per_sec` is the same program with only the
  overflow count read back (6 windows, the mean of the gaps without the
  shortest and longest; `device_capacity_whole_run_img_per_sec` over all
  6). Then the decode rate (host rANS over one window's streams, median of
  the runs, checked against the window's symbols).
* `--host-fed`: `ClipCompressor.compress_dataset` on host-resident raw
  uint8 96x96 batches (`raw_input_hw=(96, 96)`: resize and normalize on
  the card), `BENCH_RUNS` timed passes (median), then
  `decompress_dataset`.
* `--folder-fed`: disk -> bitstream: synthetic 96 px JPEGs staged in a
  temporary directory (`BENCH_FOLDER_DIR` to keep them), decoded by the
  prefetching loader, then the host-fed path. Needs PIL.

Opt-in knob, for an A/B against the default line (it adds its key to
the record; the default line and its keys are unchanged without it):
`--softmax-dtype bfloat16` sets `nn.flash_attn.SOFTMAX_DTYPE` (K1's and
K2's bf16 softmax chain). The bench's tower is bf16, where the tower's
`ln_dtype=bfloat16` gives the default's output bit for bit, so it has no
flag.

The rate model is synthetic (seeded entropy-bottleneck parameters, no
published weights in the checkout) and the tower's weights are random:
`rate_is_synthetic` is true and `bits_per_img` is not a published rate.
`device_mfu` is the tower's analytic FLOPs at the headline rate over the
H100 SXM's dense bf16 peak; `vs_baseline` compares with the reference
implementation's own 347.82 img/s encode (its README).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

BASELINE_IMG_PER_SEC = 347.82  # the reference's STL10 encode (its README)
DECODE_BASELINE = 1062.38      # the reference's unbatched CPU decode
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (NVIDIA data sheet)
REPS, DEPTH = 8, 2             # windows a run, windows in flight
CAP_REPS = 6                   # device-capacity windows


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _tower_flops_per_img() -> float:
    """Analytic forward FLOPs (2x MACs) of CLIP ViT-B/32 at 224px:
    patchify conv + 12 x (QKV/out projections + attention dots + 4x MLP)
    + the head projection."""
    n, d, layers, ff, p = 50, 768, 12, 3072, 32
    per_layer = 2 * (4 * n * d * d + 2 * n * n * d + 2 * n * d * ff)
    patchify = 2 * n * d * (p * p * 3)
    head = 2 * d * 512
    return float(layers * per_layer + patchify + head)


def _median(sorted_vals):
    """Median of an ascending-sorted list (encode and decode headlines)."""
    n = len(sorted_vals)
    return sorted_vals[n // 2] if n % 2 else \
        0.5 * (sorted_vals[n // 2 - 1] + sorted_vals[n // 2])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def synthetic_rate(seed: int = 0):
    """Seeded entropy-bottleneck parameters and per-dim affine (the
    stand-in for the published rate weights)."""
    from .coding import entropy_bottleneck as eb

    rng = np.random.default_rng(seed)
    eb_params = eb.init_params(eb.EBConfig(512),
                               torch.Generator().manual_seed(seed))
    scaling = rng.normal(1.5, 0.2, 512).astype(np.float32)
    biasing = rng.normal(0.0, 0.1, 512).astype(np.float32)
    return eb_params, scaling, biasing


class DeviceEncoder:
    """The device-resident encode of a `ClipCompressor` (its tower on its
    card, `raw_input_hw=None`): windows over images resident there, the
    compressor's symbols read back into pinned host memory behind its
    event. The bench's own steps are the salt, the normalize as one bf16
    multiply-add and the narrowing to int8."""

    def __init__(self, comp, batch: int, n_batches: int, seed: int = 0):
        from .nn.vit import CLIP_MEAN, CLIP_STD

        if comp.raw_input_hw is not None:
            raise ValueError("the device-resident bench normalizes its own "
                             "224px images: build the compressor with "
                             "raw_input_hw=None")
        comp._ensure_tower()
        self.comp, self.device = comp, comp.device
        g = torch.Generator(self.device).manual_seed(seed)
        size = comp.model.image_size
        self.data = torch.randint(0, 256, (n_batches, batch, size, size, 3),
                                  generator=g, dtype=torch.uint8,
                                  device=self.device)
        # (x / 255 - mean) / std == x * a + b, one bf16 multiply-add
        self.norm_a = torch.as_tensor(1.0 / (255.0 * CLIP_STD),
                                      device=self.device).to(torch.bfloat16)
        self.norm_b = torch.as_tensor(-CLIP_MEAN / CLIP_STD,
                                      device=self.device).to(torch.bfloat16)
        self.n_imgs = batch * n_batches

    def normalize(self, i: int, salt: int) -> torch.Tensor:
        """Batch `i` XOR-ed with `salt` and CLIP-normalized, in bf16."""
        xb = self.data[i] ^ (salt & 0xFF)
        return xb.to(torch.bfloat16) * self.norm_a + self.norm_b

    @torch.inference_mode()
    def _window(self, salt: int):
        nb, b = self.data.shape[:2]
        syms = torch.empty((nb, b, 512), dtype=torch.int8,
                           device=self.device)
        over = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(nb):
            sym = self.comp._encode_symbols(self.normalize(i, salt))
            over += (sym.abs() > 126).sum()
            syms[i] = sym.to(torch.int8)
        return syms, over

    def _readback(self, tensors):
        """Start copies of `tensors` to host memory; (host, event of the
        last copy, which the stream orders after the others)."""
        entries = [self.comp._start_readback(t) for t in tensors]
        return [h for h, _ in entries], entries[-1][1]

    def dispatch(self, salt: int):
        """Queue one window; its symbols and overflow count come back."""
        return self._readback(self._window(salt))

    def dispatch_capacity(self, salt: int):
        """Queue one window; only its overflow count comes back."""
        return self._readback(self._window(salt)[1:])

    @staticmethod
    def wait(entry):
        host, event = entry
        if event is not None:
            event.synchronize()
        return host


def _iqm(gaps):
    gaps = sorted(gaps)
    q = len(gaps) // 4
    mid = gaps[q:len(gaps) - q]
    return sum(mid) / len(mid)


def run_device_resident(comp, batch: int, n_batches: int,
                        runs: int) -> dict:
    """The default mode's measurement of `comp` (a `ClipCompressor` with
    `raw_input_hw=None`) with its codec; returns its JSON record."""
    codec, indexes = comp.codec, comp.indexes
    enc = DeviceEncoder(comp, batch, n_batches)
    n_imgs = enc.n_imgs

    # warm: first-call set-up of every kernel and of the codec's buffers
    syms, over = enc.wait(enc.dispatch(99))
    if int(over) != 0:
        raise RuntimeError("int8 symbol overflow in the warm window")
    codec.encode_batch(syms.numpy().reshape(-1, 512).astype(np.int32),
                       indexes)

    def measure_run(salt_base: int):
        pool = ThreadPoolExecutor(max_workers=1)
        marks = [time.perf_counter()]
        inflight = deque(enc.dispatch(salt_base + r) for r in range(DEPTH))
        streams, pending, overflows, host_syms = [], None, [], None
        try:
            for rep in range(REPS):
                entry = inflight.popleft()
                if rep + DEPTH < REPS:
                    inflight.append(enc.dispatch(salt_base + rep + DEPTH))
                syms, over = enc.wait(entry)
                host_syms = syms.numpy().reshape(-1, 512).astype(np.int32)
                overflows.append(int(over))
                # the previous window's coding overlaps this readback
                if pending is not None:
                    streams = pending.result()
                pending = pool.submit(codec.encode_batch, host_syms,
                                      indexes)
                marks.append(time.perf_counter())
            streams = pending.result()
        finally:
            pool.shutdown()
        if sum(overflows):
            raise RuntimeError("int8 symbol overflow")
        gaps = [b - a for a, b in zip(marks, marks[1:])]
        return (n_imgs / _iqm(gaps), REPS * n_imgs / (marks[-1] - marks[0]),
                streams, host_syms)

    results = [measure_run(100 * (i + 1)) for i in range(runs)]
    rates = sorted(r[0] for r in results)
    img_per_sec = _median(rates)
    whole_run = _median(sorted(r[1] for r in results))
    streams, last_syms = results[-1][2], results[-1][3]
    bits = 8 * float(np.mean([len(s) for s in streams]))

    codec.decode_batch(streams[:256], indexes)
    dec_rates = []
    for _ in range(runs):
        t0 = time.perf_counter()
        decoded = codec.decode_batch(streams, indexes)
        dec_rates.append(len(streams) / (time.perf_counter() - t0))
        if not np.array_equal(decoded, last_syms):
            raise RuntimeError("decode round trip mismatch")
    dec_rates.sort()
    decode_img_per_sec = _median(dec_rates)

    enc.wait(enc.dispatch_capacity(990))
    cmarks = [time.perf_counter()]
    cap = deque([enc.dispatch_capacity(991), enc.dispatch_capacity(992)])
    for r in range(CAP_REPS):
        (over,) = enc.wait(cap.popleft())
        if r + 2 < CAP_REPS:
            cap.append(enc.dispatch_capacity(993 + r))
        cmarks.append(time.perf_counter())
        if int(over):
            raise RuntimeError("int8 symbol overflow")
    cgaps = sorted(b - a for a, b in zip(cmarks, cmarks[1:]))
    cmid = cgaps[1:-1] or cgaps
    device_capacity = n_imgs / (sum(cmid) / len(cmid))
    capacity_whole = CAP_REPS * n_imgs / (cmarks[-1] - cmarks[0])

    flops = _tower_flops_per_img()
    return {
        "metric": "stl10_encode_throughput",
        "value": round(img_per_sec, 2),
        "unit": "img/sec/chip",
        "vs_baseline": round(img_per_sec / BASELINE_IMG_PER_SEC, 3),
        "value_spread": [round(rates[0], 2), round(rates[-1], 2)],
        # every image of a run over all of its time, stalls included (the
        # headline is a trimmed mean of window gaps)
        "whole_run_img_per_sec": round(whole_run, 2),
        "runs": runs,
        "input": "device_resident",
        # random tower and synthetic rate: the rate is not a published one
        "bits_per_img": round(bits, 2),
        "rate_is_synthetic": True,
        "decode_img_per_sec": round(decode_img_per_sec, 2),
        "decode_vs_baseline": round(decode_img_per_sec / DECODE_BASELINE,
                                    3),
        "decode_spread": [round(dec_rates[0], 2), round(dec_rates[-1], 2)],
        "device_capacity_img_per_sec": round(device_capacity, 2),
        "device_capacity_whole_run_img_per_sec": round(capacity_whole, 2),
        "device_mfu": round(img_per_sec * flops / PEAK_BF16_FLOPS, 4),
        "flops_per_img": round(flops),
    }


def run_compress_dataset(comp, batches_fn, n_imgs: int, runs: int,
                         warm, batch: int, metric: str, input_: str,
                         extra=None) -> dict:
    """`compress_dataset` over `batches_fn()`, `runs` timed passes after
    one warm batch, then `decompress_dataset`; the JSON record."""
    rates, rate = [], None
    with tempfile.TemporaryDirectory() as td:
        comp.compress_dataset(iter([(warm, None)]), Path(td) / "warm.bin",
                              is_info=False)
        for _ in range(runs):
            t0 = time.perf_counter()
            rate, _ = comp.compress_dataset(batches_fn(),
                                            Path(td) / "bench.bin",
                                            is_info=False)
            rates.append(n_imgs / (time.perf_counter() - t0))
        comp.decompress_dataset(Path(td) / "warm.bin", is_info=False,
                                batch_size=batch)
        t0 = time.perf_counter()
        z_hat = comp.decompress_dataset(Path(td) / "bench.bin",
                                        is_info=False, batch_size=batch)
        dec = n_imgs / (time.perf_counter() - t0)
    if len(z_hat) != n_imgs:
        raise RuntimeError(f"decoded {len(z_hat)} of {n_imgs} images")
    rates.sort()
    value = _median(rates)
    flops = _tower_flops_per_img()
    out = {
        "metric": metric,
        "value": round(value, 2),
        "unit": "img/sec/chip",
        "vs_baseline": round(value / BASELINE_IMG_PER_SEC, 3),
        "value_spread": [round(rates[0], 2), round(rates[-1], 2)],
        "runs": runs,
        "input": input_,
        "bits_per_img": round(rate, 2),
        "rate_is_synthetic": True,
        "decode_img_per_sec": round(dec, 2),
        "decode_vs_baseline": round(dec / DECODE_BASELINE, 3),
        "device_mfu": round(value * flops / PEAK_BF16_FLOPS, 4),
        "flops_per_img": round(flops),
        "backend": comp.device.type,
    }
    out.update(extra or {})
    return out


def stage_jpegs(root: Path, n_imgs: int, side: int, quality: int = 90,
                seed: int = 0) -> list:
    """Write n synthetic natural-ish JPEGs (smooth random gradients and
    mild texture) under `root`: a realistic decode cost."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    paths = []
    for i in range(n_imgs):
        freq = rng.uniform(1.0, 6.0, (3, 2)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, (3,)).astype(np.float32)
        base = np.stack([np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) + p)
                         for f, p in zip(freq, phase)], -1)
        img = (127.5 + 100.0 * base
               + rng.normal(0, 12, (side, side, 3))).clip(0, 255)
        p = root / f"{i:06d}.jpg"
        Image.fromarray(img.astype(np.uint8)).save(p, quality=quality)
        paths.append(p)
    return paths


def _compressor(device, raw_hw=(96, 96)):
    from .hub.compressor import ClipCompressor

    eb_params, scaling, biasing = synthetic_rate()
    return ClipCompressor(eb_params, scaling, biasing, raw_input_hw=raw_hw,
                          device=device)


def main_device_resident(device=None) -> dict:
    return run_device_resident(
        _compressor(device, raw_hw=None), _env_int("BENCH_BATCH", 512),
        _env_int("BENCH_N_BATCHES", 32), _env_int("BENCH_RUNS", 3))


def main_host_fed(device=None) -> dict:
    from .core.device import resolve_device

    device = resolve_device(device)
    batch, nb = _env_int("BENCH_BATCH", 512), _env_int("BENCH_N_BATCHES", 32)
    comp = _compressor(device)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (nb, batch, 96, 96, 3), dtype=np.uint8)
    return run_compress_dataset(
        comp, lambda: ((xb, None) for xb in data), batch * nb,
        _env_int("BENCH_RUNS", 3), data[0], batch,
        "stl10_encode_throughput_host_fed", "host_resident_uint8_96px")


def main_folder_fed(device=None) -> dict:
    from .core.device import resolve_device
    from .data.loader import decode_image_batch, n_workers, prefetch

    device = resolve_device(device)
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise RuntimeError("--folder-fed needs PIL (Pillow) to write and "
                           "decode its JPEGs") from e
    batch, nb = _env_int("BENCH_BATCH", 512), _env_int("BENCH_N_BATCHES", 32)
    n_imgs = batch * nb
    keep = os.environ.get("BENCH_FOLDER_DIR")
    with tempfile.TemporaryDirectory() as td:
        root = Path(keep or td)
        root.mkdir(parents=True, exist_ok=True)
        paths = sorted(root.glob("*.jpg"))[:n_imgs]
        if len(paths) < n_imgs:
            paths = stage_jpegs(root, n_imgs, 96)
        comp = _compressor(device)

        def batches():
            for i in range(0, n_imgs, batch):
                yield decode_image_batch(paths[i:i + batch], (96, 96)), None

        t0 = time.perf_counter()
        for i in range(0, n_imgs, batch):
            decode_image_batch(paths[i:i + batch], (96, 96))
        loader = n_imgs / (time.perf_counter() - t0)
        return run_compress_dataset(
            comp, lambda: prefetch(batches()), n_imgs,
            _env_int("BENCH_RUNS", 3),
            decode_image_batch(paths[:batch], (96, 96)), batch,
            "stl10_encode_throughput_folder_fed", "jpeg_folder_96px",
            extra={"loader_img_per_sec": round(loader, 2),
                   "loader_workers": n_workers()})


def main(argv=None) -> int:
    from .nn import flash_attn

    p = argparse.ArgumentParser(prog="python -m lossyless_tpu_torch.bench")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--host-fed", action="store_true")
    mode.add_argument("--folder-fed", action="store_true")
    p.add_argument("--softmax-dtype", choices=["float32", "bfloat16"],
                   help="K1's and K2's softmax chain (SOFTMAX_DTYPE)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    fn = main_host_fed if args.host_fed else \
        main_folder_fed if args.folder_fed else main_device_resident
    knobs = {"softmax_dtype": args.softmax_dtype} if args.softmax_dtype \
        else {}
    saved = flash_attn.SOFTMAX_DTYPE
    if args.softmax_dtype:
        flash_attn.SOFTMAX_DTYPE = getattr(torch, args.softmax_dtype)
    try:
        record = fn()
    finally:
        flash_attn.SOFTMAX_DTYPE = saved
    record.update(knobs)
    print(card_line(), flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
