"""Classical codec baselines: JPEG / WebP / PNG / identity.

Counterpart of `lossyless_tpu/compressors/classical.py`: the same
evaluation-only interface as the learnable compressor. It compresses a
batch of images with a standard codec through Pillow (libjpeg, libwebp,
zlib) and reports rate (bpp, bits) and distortion (MSE, PSNR, MS-SSIM)
against the originals. Host work: a batch on the card is copied to the
host first, and float batches become bytes there in numpy, as the JAX
package makes them, so that both give the codec the same bytes.
"""

from __future__ import annotations

import dataclasses
import io
import time

import numpy as np
import torch
from PIL import Image

from ..train.metrics import MetricAccumulator, namespaced

# ---------------------------------------------------------------------------
# MS-SSIM (Wang, Simoncelli & Bovik 2003) — the second distortion metric the
# reference logs for classical baselines (classical_compressors.py:20-26 via
# compressai.utils.bench.codecs). Pure numpy, pytorch-msssim conventions:
# 11-tap gaussian (sigma 1.5), valid-mode windows, 2x average-pool between
# scales, standard 5-scale weights. Images too small for 5 scales (an 11-tap
# window needs >=11 px at the coarsest scale) use the largest feasible scale
# count with renormalized weights.
# ---------------------------------------------------------------------------

_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter2(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable valid-mode gaussian filter over the H, W axes of NHWC."""
    from numpy.lib.stride_tricks import sliding_window_view

    v = sliding_window_view(x, len(k), axis=1)
    x = np.einsum("bhwct,t->bhwc", v, k)
    v = sliding_window_view(x, len(k), axis=2)
    return np.einsum("bhwct,t->bhwc", v, k)


def _avg_pool2(x: np.ndarray) -> np.ndarray:
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))


def ms_ssim(x: np.ndarray, y: np.ndarray, data_range: float = 1.0) -> float:
    """Multi-scale SSIM between NHWC batches (higher is better, max 1.0)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape or x.ndim != 4:
        raise ValueError(f"expected equal NHWC shapes, got {x.shape} {y.shape}")
    # window shrinks (odd) for tiny images so valid-mode filtering never
    # exceeds the spatial extent — same degradation skimage applies
    mind = min(x.shape[1], x.shape[2])
    win = min(11, mind if mind % 2 else mind - 1)
    if win < 1:
        raise ValueError(f"images too small for SSIM: {x.shape}")
    # coarsest scale must still fit one valid win-tap window
    max_scales = 1 + int(np.floor(np.log2(mind / win)))
    n_scales = int(np.clip(max_scales, 1, len(_MSSSIM_WEIGHTS)))
    weights = _MSSSIM_WEIGHTS[:n_scales] / _MSSSIM_WEIGHTS[:n_scales].sum() \
        if n_scales < len(_MSSSIM_WEIGHTS) else _MSSSIM_WEIGHTS

    k = _gaussian_kernel(win)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for i in range(n_scales):
        mu1, mu2 = _filter2(x, k), _filter2(y, k)
        s11 = _filter2(x * x, k) - mu1 * mu1
        s22 = _filter2(y * y, k) - mu2 * mu2
        s12 = _filter2(x * y, k) - mu1 * mu2
        cs = (2 * s12 + c2) / (s11 + s22 + c2)
        if i == n_scales - 1:
            lum = (2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)
            vals.append(float((lum * cs).mean()))
        else:
            vals.append(float(cs.mean()))
            x, y = _avg_pool2(x), _avg_pool2(y)
    # negative contrast terms (possible on pathological inputs) are clamped
    # so the weighted geometric mean stays real, as pytorch-msssim does
    vals = np.maximum(np.asarray(vals), 0.0)
    return float(np.prod(vals ** weights))


@dataclasses.dataclass
class ClassicalCompressor:
    """`mode` in {jpeg, webp, png, identity}; `quality` for lossy modes."""

    mode: str = "jpeg"
    quality: int = 95

    def _codec_args(self):
        if self.mode == "jpeg":
            return dict(format="JPEG", quality=self.quality)
        if self.mode == "webp":
            return dict(format="WEBP", quality=self.quality)
        if self.mode == "png":
            return dict(format="PNG")
        raise ValueError(f"unknown mode {self.mode}")

    def compress_one(self, img_uint8: np.ndarray) -> bytes:
        if self.mode == "identity":
            return img_uint8.tobytes()
        pil = Image.fromarray(img_uint8.squeeze())
        with io.BytesIO() as f:
            pil.save(f, **self._codec_args())
            return f.getvalue()

    def decompress_one(self, data: bytes, shape) -> np.ndarray:
        if self.mode == "identity":
            return np.frombuffer(data, np.uint8).reshape(shape)
        with io.BytesIO(data) as f:
            img = Image.open(f)
            # codecs without grayscale support (WebP) decode to RGB;
            # convert back to the expected channel count
            if shape[-1] == 1 and img.mode != "L":
                img = img.convert("L")
            elif shape[-1] == 3 and img.mode != "RGB":
                img = img.convert("RGB")
            arr = np.asarray(img)
        return arr.reshape(shape)

    def batch_run(self, x_uint8: np.ndarray) -> tuple[np.ndarray, dict]:
        """Compress+decompress a uint8 NHWC batch; return (x_hat, logs).

        Mirrors `PillowCodec.batch_run` (classical_compressors.py:27-64):
        logs rate (bpp, n_bits) and distortion (mse, psnr) plus codec times.
        """
        b, h, w, c = x_uint8.shape
        x_hat = np.empty_like(x_uint8)
        n_bytes = 0
        t_enc = t_dec = 0.0
        for i in range(b):
            t0 = time.time()
            data = self.compress_one(x_uint8[i])
            t_enc += time.time() - t0
            n_bytes += len(data)
            t0 = time.time()
            x_hat[i] = self.decompress_one(data, (h, w, c))
            t_dec += time.time() - t0

        xf = x_uint8.astype(np.float32) / 255.0
        xhf = x_hat.astype(np.float32) / 255.0
        mse = float(((xf - xhf) ** 2).mean())
        psnr = float(10 * np.log10(1.0 / max(mse, 1e-12)))
        logs = {
            "n_bits": 8.0 * n_bytes / b,
            "bpp": 8.0 * n_bytes / (b * h * w),
            "mse": mse,
            "psnr": psnr,
            "ms_ssim": ms_ssim(xf, xhf),
            "distortion": mse,
            "rate": 8.0 * n_bytes / b,
            "compress_time": t_enc / b,
            "receiver_time": t_dec / b,
        }
        return x_hat, logs

    def evaluate(self, batches, stage: str = "feat") -> dict:
        """Test-only evaluation over (x, y, aux) batches: NHWC uint8, or
        floats in [0, 1], as arrays or as tensors on any device."""
        acc = MetricAccumulator()
        for x, _, __ in batches:
            x = to_uint8(x)
            _, logs = self.batch_run(x)
            acc.update(logs, weight=len(x))
        return namespaced(acc.means(), "test", stage)


def to_uint8(x) -> np.ndarray:
    """An NHWC batch as uint8 on the host. Floats are scaled by 255 and
    truncated in float32 numpy, as the JAX package does: `k / 255 * 255`
    can land one ulp under `k`, and torch's kernels on the card need not
    round the product as numpy does."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype != np.uint8:
        x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    return x


def get_classical_compressor(mode: str, **kwargs) -> ClassicalCompressor:
    return ClassicalCompressor(mode=mode, **kwargs)
