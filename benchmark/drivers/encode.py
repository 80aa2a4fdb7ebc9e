"""Hub encode: `ClipCompressor.compress_dataset` over a dataset held in
host memory, one pass after another.

Traffic parameters: `images` (the dataset's size), `raw_hw` (the raw
uint8 images' height and width; the compressor resizes and normalizes them
on the card), `batch` (the batch size of the passes; the last batch of a
pass is ragged when `batch` does not divide `images`), `check_images`
(how many images, drawn from the seed, the comparison reads in every
pass).

A pass compresses the whole dataset into a dataset file under TMPDIR.
Set-up runs one pass, which warms every shape the passes use. The window
runs whole passes until `seconds` have gone by: `encode_img_per_s` is
every image of every pass over the window's whole time. The traced slice
is one more pass.

The check decodes the sampled images' streams of every pass's file with
the plain decoder and compares the symbols with the plain float32 tower's
on the same raw images, weights and rate parameters.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import seeded, trace
from benchmark.reference import coding
from benchmark.reference import vit as ref_vit

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Session:
    def __init__(self, cell, seed: int, device: str):
        self.cfg, self.tr, self.limits = cell.config, cell.traffic, cell.limits
        self.seed, self.device = seed, torch.device(device)
        self.attempted = self.failed = 0
        self.files: list[str] = []
        self.info: dict = {}

    # -- the program ------------------------------------------------------

    def setup(self):
        from lossyless_tpu_torch.hub.compressor import ClipCompressor
        from lossyless_tpu_torch.nn.vit import VisionTransformer

        t, r = self.cfg["tower"], self.cfg["rate"]
        dtype = DTYPES[t["dtype"]]
        g = seeded.generator(self.seed, self.device)
        shapes = ref_vit.weight_shapes(t["width"], t["layers"], t["patch"],
                                       t["image"], t["out_dim"])
        self.weights = seeded.tower_weights(shapes, g, self.device, dtype)
        self.prior = seeded.factorized_prior(
            t["out_dim"], r["filters"], r["init_scale"], g, self.device)
        self.scaling, self.biasing = seeded.affine(
            t["out_dim"], g, self.device, r["log_scale"])
        h, w = self.tr["raw_hw"]
        self.images = seeded.images(self.tr["images"], h, w, g, self.device)

        with torch.device("meta"):
            tower = VisionTransformer(
                patch_size=t["patch"], width=t["width"], layers=t["layers"],
                heads=t["heads"], out_dim=t["out_dim"],
                image_size=t["image"], dtype=dtype)
        self.comp = ClipCompressor(
            self.prior, self.scaling, self.biasing, clip_params=self.weights,
            dtype=dtype, model=tower, raw_input_hw=(h, w),
            device=self.device)
        self.tmp = tempfile.mkdtemp(prefix="bench-encode-")
        self._pass(os.path.join(self.tmp, "warm.bin"))
        os.unlink(os.path.join(self.tmp, "warm.bin"))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def _batches(self):
        b = self.tr["batch"]
        for i in range(0, len(self.images), b):
            yield self.images[i:i + b], None

    def _pass(self, path: str):
        self.comp.compress_dataset(self._batches(), path, is_info=False)

    def _next_file(self) -> str:
        path = os.path.join(self.tmp, f"pass{len(self.files)}.bin")
        self.files.append(path)
        return path

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        passes = 0
        pass_s = []
        while passes == 0 or time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            self._pass(self._next_file())
            pass_s.append(time.perf_counter() - t)
            passes += 1
        elapsed = time.perf_counter() - t0
        n = passes * len(self.images)
        self.attempted = n
        self.info.update(window_passes=passes, window_s=elapsed,
                         pass_s=pass_s, file_bytes=os.path.getsize(
                             self.files[-1]))
        return {"encode_img_per_s": n / elapsed}

    def trace(self):
        """One pass under the profiler, the codec's `encode_batch` timed and
        the attention kernels' launches counted."""
        from lossyless_tpu_torch.nn import flash_attn

        codec, rans_s = self.comp.codec, []
        encode_batch = codec.encode_batch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = encode_batch(*args, **kwargs)
            rans_s.append(time.perf_counter() - t0)
            return out

        codec.encode_batch = timed
        holder, before = {}, dict(flash_attn.LAUNCHES)
        try:
            with trace.profiled(holder):
                self._pass(self._next_file())
        finally:
            del codec.encode_batch
        self.info["slice_launches"] = {
            k: v - before.get(k, 0) for k, v in flash_attn.LAUNCHES.items()}
        sliced = holder["slice"]
        sliced.spans["rans"] = rans_s
        b, n = self.tr["batch"], len(self.images)
        self.info["slice_batches"] = [min(b, n - i) for i in range(0, n, b)]
        self.attempted += n
        return sliced

    def closing(self):
        """Nothing runs after the window: the check reads its files."""

    def free(self):
        del self.comp
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def check(self) -> dict:
        """The sampled images' symbols in every pass's file against the
        plain tower's; the files are removed afterwards."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            ref = self.reference_symbols("fp32")
            dec, bad, missing = self._decoded()
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        expect = np.tile(ref, (len(dec) // len(ref), 1))
        numbers = compare(dec, expect, bad)
        limits = self.limits
        wrong = bad.copy()
        if len(dec):
            wrong |= (dec != expect).mean(1) > limits["worst_image_flip_share"]
        self.failed = int(missing + wrong.sum())
        checks = {"missing_records": {"value": missing, "limit": 0},
                  "bad_streams": {"value": int(bad.sum()), "limit": 0}}
        for k, v in numbers.items():
            checks[k] = {"value": v, "limit": limits[k]}
        return checks

    def control(self) -> dict:
        """The comparison's numbers of the reference in float8 e4m3 put in
        the program's place (no coding: its symbols as they come)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = self.reference_symbols("fp32")
        low = self.reference_symbols("fp8")
        return compare(low, ref, np.zeros(len(ref), bool))

    @property
    def sample(self) -> np.ndarray:
        n = len(self.images)
        k = min(n, self.tr["check_images"])
        return np.sort(seeded.rng(self.seed, 1).choice(n, k, replace=False))

    def reference_symbols(self, precision: str) -> np.ndarray:
        """The plain tower's symbols of the sampled images."""
        t = self.cfg["tower"]
        tower = ref_vit.Tower(self.weights, t["heads"], precision)
        dev = self.device
        _, _, med = coding.cdf_tables(self.prior)
        out = ref_vit.symbols(
            tower, torch.from_numpy(self.images[self.sample]).to(dev),
            torch.from_numpy(self.scaling).to(dev),
            torch.from_numpy(self.biasing).to(dev),
            torch.from_numpy(med).to(dev))
        return out.cpu().numpy()

    def _decoded(self):
        """(symbols, bad, missing records) of the sampled images over the
        passes' files, decoded with the plain codec."""
        cdfs, offsets, _ = coding.cdf_tables(self.prior)
        n, sample = len(self.images), self.sample
        streams, missing = [], 0
        for path in self.files:
            records = coding.read_records(path)
            if len(records) != n:
                missing += abs(n - len(records))
                continue
            streams += [records[i] for i in sample]
        if not streams:
            return np.zeros((0, len(cdfs)), np.int64), np.zeros(0, bool), \
                missing
        dec, bad = coding.decode(streams, cdfs, offsets)
        return dec, bad, missing


def compare(got: np.ndarray, ref: np.ndarray, bad: np.ndarray) -> dict:
    """The numbers the encode check compares: the share of symbols off the
    reference's and the largest such share of one image (bad streams
    count as wholly off)."""
    if not len(got):
        return {"flip_share": 1.0, "worst_image_flip_share": 1.0}
    diff = (got != ref) | bad[:, None]
    return {"flip_share": float(diff.mean()),
            "worst_image_flip_share": float(diff.mean(1).max())}
