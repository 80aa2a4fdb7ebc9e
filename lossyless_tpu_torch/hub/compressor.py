"""Deployment CLIP compressor on a CUDA card.

Counterpart of `lossyless_tpu/hub/compressor.py` (`ClipCompressor`) with
the same public surface — `compress`, `decompress`, `get_rate`,
`compress_dataset`, `decompress_dataset` — and byte-identical streams and
dataset files (`coding/bitstream.py`).

Encode on the card: optional preprocess of raw uint8 batches
(`raw_input_hw`), the CLIP ViT-B/32 tower in bf16 with the hand-written
attention kernels, the per-dim affine and the rounding to int32 symbols;
only the symbols cross back to the host, where rANS codes them. Decode is
host-only numpy (rANS decode, add the medians, undo the affine).

`compress_dataset` keeps the host and the card busy together: each batch's
symbols are copied into pinned host memory asynchronously behind a CUDA
event, the previous batch is drained with `event.synchronize()` (a blocking
`.cpu()` would also wait for the batch queued after it on the same stream),
and rANS runs on a one-thread pool while the card computes.

With `mesh=` (`core/mesh.py::make_mesh`) one process encodes over several
devices, as JAX's `shard_map` body does, with no collectives: a replica of
the tower (and of the rate's parameters) per mesh entry, a batch padded to
a multiple of the mesh size by repeating its last row (JAX's
`_pad_for_mesh`), split in order, each shard launched on its replica's
device and stream, the symbols (or features) gathered in order on the
first device and the pad dropped; rANS codes the whole batch as before.
`__call__`, `compress`, `compress_dataset` and `get_rate` take that path;
decode is host work and does not change.
"""

from __future__ import annotations

import copy
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..coding import entropy_bottleneck as eb
from ..coding.bitstream import read_dataset, write_dataset
from ..coding.rans import RansCodec
from ..core.device import resolve_device
from ..nn.vit import clip_preprocess, convert_openai_clip_weights, vit_b32


class ClipCompressor:
    """CLIP ViT-B/32 + per-dim affine + factorized entropy bottleneck.

    Parameters
    ----------
    eb_params : dict
        Entropy-bottleneck parameters (numpy arrays or tensors, e.g. from
        `hub.load_reference.load_factorized_rate`).
    scaling, biasing : (512,) arrays
        The per-dim affine.
    clip_params : state dict, optional
        Tower weights in this package's layout (`nn.vit.params_from_flax`
        or `convert_openai_clip_weights`); seeded random init if None.
    dtype : the tower's compute and storage dtype (bf16 by default).
    seed : seed of the random tower init.
    model : override the tower (a module mapping normalized 224px NHWC
        images to 512-d embeddings, with an `init_weights(generator)`
        method); default CLIP ViT-B/32.
    raw_input_hw : when set to the source (H, W), `compress`,
        `compress_dataset` and `__call__` accept RAW uint8 NHWC batches;
        the bicubic resize to 224 and CLIP normalization run on the card.
    table_arithmetic : "compressai" (default; CompressAI's fp32 table build,
        so streams cross-decode with the reference) or "float64".
    device : "cuda" unless given; raises if CUDA is absent and no device
        was asked for. With a mesh, its first device unless given.
    mesh : a `core.mesh.Mesh`: encode over its devices (module docstring);
        the streams equal one device's.
    """

    def __init__(self, eb_params, scaling, biasing, clip_params=None,
                 dtype=torch.bfloat16, seed: int = 0, model=None,
                 raw_input_hw: tuple | None = None,
                 table_arithmetic: str = "compressai", device=None,
                 mesh=None):
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self._replicas = None
        self.z_dim = 512
        self.raw_input_hw = tuple(raw_input_hw) if raw_input_hw else None
        if model is None:
            # no storage until the first encode: decompress-only use never
            # pays for the 88M-parameter tower
            with torch.device("meta"):
                model = vit_b32(dtype=dtype)
        self.model = model.eval()
        self._dtype = dtype
        self._seed = seed
        self._tower_ready = False
        if clip_params is not None:
            self._materialize()
            self.model.load_state_dict(clip_params)
            self._place_tower()

        eb_np = {k: eb.to_numpy(v) for k, v in eb_params.items()}
        self.eb_params = {k: torch.as_tensor(v, dtype=torch.float32,
                                             device=self.device)
                          for k, v in eb_np.items()}
        self.scaling = torch.as_tensor(np.asarray(scaling, np.float32),
                                       device=self.device)
        self.biasing = torch.as_tensor(np.asarray(biasing, np.float32),
                                       device=self.device)

        self.table_arithmetic = table_arithmetic
        tables = eb.build_cdf_tables(eb_np, arithmetic=table_arithmetic)
        self.codec = RansCodec(tables.quantized_cdf, tables.cdf_length,
                               tables.offset)
        self.medians_np = np.asarray(eb.medians(eb_np), np.float32)
        self.indexes = np.arange(self.z_dim, dtype=np.int32)
        # host copies of the output affine: decode is pure host work
        self._out_scale_np = np.exp(np.asarray(scaling, np.float32))
        self._biasing_np = np.asarray(biasing, np.float32)

    # -- device programs ----------------------------------------------------

    def _materialize(self):
        if any(p.is_meta for p in self.model.parameters()):
            self.model.to_empty(device="cpu")

    def _place_tower(self):
        # every tower param is stored in the compute dtype, LayerNorm params
        # included (they are upcast inside the fp32 LayerNorms)
        self.model.to(device=self.device, dtype=self._dtype)
        self._tower_ready = True

    def _ensure_tower(self):
        """Random-init the tower (seeded, on the CPU) at first encode use;
        then the mesh's replicas."""
        if not self._tower_ready:
            self._materialize()
            self.model.init_weights(torch.Generator().manual_seed(self._seed))
            self._place_tower()
        if self._replicas is None:
            self._replicas = [_Replica(self.model, self.eb_params,
                                       self.scaling, self.biasing,
                                       self.device, None)]
            if self.mesh is not None:
                devices = [resolve_device(d) for d in self.mesh.devices]
                # the first entry on `self.device` runs the tower itself
                own = devices.index(self.device) \
                    if self.device in devices else -1
                self._replicas = [self._replica(d, i == own)
                                  for i, d in enumerate(devices)]

    def _replica(self, device, own: bool) -> "_Replica":
        """The tower and the rate's parameters on `device` (`own`: this
        compressor's, else a copy), with a CUDA stream of its own there."""
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        if own:
            return _Replica(self.model, self.eb_params, self.scaling,
                            self.biasing, device, stream)
        return _Replica(
            copy.deepcopy(self.model).to(device),
            {k: v.to(device) for k, v in self.eb_params.items()},
            self.scaling.to(device), self.biasing.to(device), device,
            stream)

    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        if t.device.type == "cpu" and self.device.type == "cuda":
            # from pinned memory, so the copy is asynchronous
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _maybe_preprocess(self, x):
        return x if self.raw_input_hw is None else self.preprocess_batch(x)

    def _z_in(self, x, r: "_Replica"):
        """The tower's embedding of x on replica r, through the affine."""
        z = r.model(self._maybe_preprocess(x))
        return (z.float() + r.biasing) * torch.exp(r.scaling)

    def _symbols_on(self, x, r: "_Replica"):
        med = eb.medians(r.eb_params)[None, :]
        return torch.round(self._z_in(x, r) - med).to(torch.int32)

    def _features_on(self, x, r: "_Replica"):
        z_hat = eb.quantize(r.eb_params, self._z_in(x, r), "dequantize")
        return z_hat / torch.exp(r.scaling) - r.biasing

    def _encode_symbols(self, x):
        """int32 symbols of a device batch (over the mesh when there is
        one)."""
        return self._over_mesh(self._symbols_on, x)

    def _features(self, x):
        return self._over_mesh(self._features_on, x)

    def _over_mesh(self, fn, x):
        """`fn(shard, replica)` over the replicas: x padded to a multiple
        of the mesh size with its last row, split in order, each shard on
        its replica's device and stream; the outputs gathered in order on
        the first device, the pad dropped. One replica: `fn(x)`."""
        if len(self._replicas) == 1:
            return fn(x, self._replicas[0])
        n, B = len(self._replicas), x.shape[0]
        pad = (-B) % n
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        per = x.shape[0] // n
        cuda = x.device.type == "cuda"
        main = torch.cuda.current_stream(x.device) if cuda else None
        outs = []
        for i, r in enumerate(self._replicas):
            shard = x[i * per:(i + 1) * per]
            if r.stream is None:
                outs.append(fn(shard.to(r.device), r))
                continue
            r.stream.wait_stream(main)       # x is ready
            x.record_stream(r.stream)        # and read there
            with torch.cuda.stream(r.stream):
                outs.append(fn(shard.to(r.device, non_blocking=True), r))
        for r, out in zip(self._replicas, outs):
            if r.stream is not None:
                main.wait_stream(r.stream)
                out.record_stream(main)
        out = torch.cat([o.to(self.device, non_blocking=True) for o in outs])
        return out[:B]

    def _start_readback(self, dev: torch.Tensor):
        """Copy device symbols into pinned host memory without blocking."""
        if dev.device.type != "cuda":
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        return host, event

    # -- public API ---------------------------------------------------------

    def __call__(self, x, is_compress: bool = False):
        if is_compress:
            return self.compress(x)
        self._ensure_tower()
        with torch.inference_mode():
            return self._features(self._to_device(x)).cpu().numpy()

    def compress(self, x) -> list[bytes]:
        """Batch of images -> per-image byte strings."""
        self._ensure_tower()
        with torch.inference_mode():
            symbols = self._encode_symbols(self._to_device(x)).cpu().numpy()
        return self.codec.encode_batch(symbols, self.indexes)

    def decompress(self, byte_strings: list[bytes]) -> np.ndarray:
        symbols = self.codec.decode_batch(byte_strings, self.indexes)
        z_hat = symbols.astype(np.float32) + self.medians_np[None]
        # host-only inverse affine: the same fp32 arithmetic as
        # _process_z_out, no device round-trip per batch
        return z_hat / self._out_scale_np[None] - self._biasing_np[None]

    def get_rate(self, x) -> float:
        """Mean coded bits per image over a batch."""
        streams = self.compress(x)
        return 8.0 * sum(len(s) for s in streams) / len(streams)

    def compress_dataset(self, batches: Iterable, file, label_file=None,
                         is_info: bool = True, n_total: int | None = None):
        """Compress an iterable of (x, y) batches into a dataset bitstream.

        Batch i+1 is queued on the card before batch i is drained, so the
        card's compute, the readback and host rANS all overlap.
        """
        self._ensure_tower()
        start = time.time()
        all_streams: list[bytes] = []
        labels = []
        pool = ThreadPoolExecutor(max_workers=1)
        pending = None        # host-coding future for the previous batch
        inflight = None       # (pinned host symbols, copy-done event)

        def _drain(entry):
            nonlocal pending
            host, event = entry
            if event is not None:
                event.synchronize()            # waits on THIS batch only
            symbols = host.numpy()
            if pending is not None:
                all_streams.extend(pending.result())
            pending = pool.submit(self.codec.encode_batch, symbols,
                                  self.indexes)

        try:
            with torch.inference_mode():
                for item in batches:
                    x, y = item if isinstance(item, (tuple, list)) \
                        else (item, None)
                    dev = self._encode_symbols(self._to_device(x))
                    entry = self._start_readback(dev)
                    if label_file is not None and y is not None:
                        # natural dtype: a narrowing cast would wrap ids
                        labels.append(np.asarray(y))
                    if inflight is not None:
                        _drain(inflight)
                    inflight = entry
                if inflight is not None:
                    _drain(inflight)
            if pending is not None:
                all_streams.extend(pending.result())
        finally:
            pool.shutdown()

        write_dataset(file, all_streams, len(all_streams))
        enc_time = (time.time() - start) / max(1, len(all_streams))
        rate = 8 * Path(file).stat().st_size / max(1, len(all_streams))

        if label_file is not None and labels:
            np.save(label_file, np.concatenate(labels), allow_pickle=False)
        if is_info:
            print(f"Rate: {rate:.2f} bits/img | Encoding: {1/enc_time:.2f} img/sec ")
        return rate, 1.0 / enc_time

    def decompress_dataset(self, file, label_file=None, is_info: bool = True,
                           batch_size: int = 1024):
        """Decode a dataset bitstream back to (N, 512) features (batched,
        streaming `batch_size` records at a time)."""
        start = time.time()
        out = []
        batch: list[bytes] = []
        for s in read_dataset(file):
            batch.append(s)
            if len(batch) == batch_size:
                out.append(self.decompress(batch))
                batch = []
        if batch:
            out.append(self.decompress(batch))
        z_hat = np.concatenate(out) if out else np.empty((0, self.z_dim))
        dec_time = (time.time() - start) / max(1, len(z_hat))
        if is_info:
            print(f"Decoding: {1/dec_time:.2f} img/sec ")
        if label_file is not None:
            y = np.load(label_file, allow_pickle=False)
            if np.issubdtype(y.dtype, np.integer):
                y = y.astype(np.int64)  # class labels; floats stay as-is
            return z_hat, y
        return z_hat

    @staticmethod
    def preprocess_batch(x_uint8_nhwc) -> torch.Tensor:
        """[0,255] uint8 NHWC of any size -> normalized 224px float batch,
        on the input's device."""
        x = torch.as_tensor(x_uint8_nhwc).float() / 255.0
        return clip_preprocess(x)


@dataclass
class _Replica:
    """One mesh entry's tower and rate parameters, device and stream."""

    model: torch.nn.Module
    eb_params: dict
    scaling: torch.Tensor
    biasing: torch.Tensor
    device: torch.device
    stream: "torch.cuda.Stream | None"


def load_pretrained(beta: str = "b005", clip_state_dict=None,
                    dtype=torch.bfloat16, **kwargs) -> ClipCompressor:
    """Build a ClipCompressor from the reference's published rate weights.

    CLIP weights are converted when given, else the tower is seeded random.
    Extra kwargs (`raw_input_hw=`, `device=`, ...) pass through.
    """
    from .load_reference import load_factorized_rate

    eb_params, scaling, biasing = load_factorized_rate(beta)
    clip_params = None
    if clip_state_dict is not None:
        clip_params = convert_openai_clip_weights(clip_state_dict)
    return ClipCompressor(eb_params, scaling, biasing, clip_params, dtype,
                          **kwargs)
