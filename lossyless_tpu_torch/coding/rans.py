"""Host-side rANS entropy codec (ctypes binding to the C++ core).

Counterpart of `lossyless_tpu/coding/rans.py`, over the port's own copy of
``csrc/rans.cpp``:

* ``encode_with_indexes`` / ``decode_with_indexes`` — per-message API with
  the reference coder's semantics (16-bit precision, 4-bit bypass escapes).
* ``encode_batch`` / ``decode_batch`` — batched multithreaded coding.
* ``encode_batch_varidx`` / ``decode_batch_varidx`` — the same with an
  index row per message (the hyperprior's Gaussian-conditional stream).

The library is compiled with g++ at first use into the port's build
directory (``nn/_build.py``), never next to the JAX package's source. A
failed build raises. The pure-Python codec below writes bit-identical
streams; it is the independent cross-check of the native one in the tests.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..nn import _build

_lock = threading.Lock()
_lib = None

PRECISION = 16
BYPASS_PRECISION = 4
MAX_BYPASS_VAL = (1 << BYPASS_PRECISION) - 1
_RANS_L = 1 << 31


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load("rans")
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rans_encode_with_indexes.restype = ctypes.c_int64
        lib.rans_encode_with_indexes.argtypes = [
            i32p, i32p, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64,
            u8p, ctypes.c_int64,
        ]
        lib.rans_decode_with_indexes.restype = ctypes.c_int64
        lib.rans_decode_with_indexes.argtypes = [
            u8p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, i32p, i32p,
            ctypes.c_int64, i32p,
        ]
        lib.rans_encode_batch.restype = ctypes.c_int64
        lib.rans_encode_batch.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p, i32p,
            ctypes.c_int64, u8p, ctypes.c_int64, i64p, ctypes.c_int64,
        ]
        lib.rans_decode_batch.restype = ctypes.c_int64
        lib.rans_decode_batch.argtypes = [
            u8p, i64p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, i32p, i32p,
            ctypes.c_int64, i32p, ctypes.c_int64,
        ]
        lib.rans_encode_batch_varidx.restype = ctypes.c_int64
        lib.rans_encode_batch_varidx.argtypes = \
            lib.rans_encode_batch.argtypes
        lib.rans_decode_batch_varidx.restype = ctypes.c_int64
        lib.rans_decode_batch_varidx.argtypes = \
            lib.rans_decode_batch.argtypes
        lib.pmf_to_quantized_cdf.restype = ctypes.c_int32
        lib.pmf_to_quantized_cdf.argtypes = [f32p, ctypes.c_int32,
                                             ctypes.c_int32, i32p]
        _lib = lib
        return _lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Pure-Python codec (bit-identical streams; the independent cross-check of
# the native codec in the tests).
# ---------------------------------------------------------------------------


def _py_buffer_symbols(symbols, indexes, cdfs, cdf_lengths, offsets):
    syms = []  # (start, range, bypass)
    for sym, idx in zip(symbols, indexes):
        cdf = cdfs[idx]
        # Python-int domain: mixing numpy int32 scalars into the zigzag
        # arithmetic below overflows for extreme symbols
        max_value = int(cdf_lengths[idx]) - 2
        value = int(sym) - int(offsets[idx])
        raw_val, escaped = 0, False
        if value < 0:
            raw_val, value, escaped = -2 * value - 1, max_value, True
        elif value >= max_value:
            raw_val, value, escaped = 2 * (value - max_value), max_value, True
        syms.append((int(cdf[value]), int(cdf[value + 1] - cdf[value]), False))
        if escaped:
            n_bypass = 0
            while (raw_val >> (n_bypass * BYPASS_PRECISION)) != 0:
                n_bypass += 1
            val = n_bypass
            while val >= MAX_BYPASS_VAL:
                syms.append((MAX_BYPASS_VAL, 0, True))
                val -= MAX_BYPASS_VAL
            syms.append((val, 0, True))
            for j in range(n_bypass):
                syms.append(((raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL, 0, True))
    return syms


def _py_encode(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    syms = _py_buffer_symbols(symbols, indexes, cdfs, cdf_lengths, offsets)
    words = []
    state = _RANS_L
    for start, rng, bypass in reversed(syms):
        start, rng = int(start), int(rng)
        if bypass:
            freq = 1 << (PRECISION - BYPASS_PRECISION)
            x_max = ((_RANS_L >> PRECISION) << 32) * freq
            if state >= x_max:
                words.append(state & 0xFFFFFFFF)
                state >>= 32
            state = (state << BYPASS_PRECISION) | start
        else:
            x_max = ((_RANS_L >> PRECISION) << 32) * rng
            if state >= x_max:
                words.append(state & 0xFFFFFFFF)
                state >>= 32
            state = ((state // rng) << PRECISION) + (state % rng) + start
    # flush: state low word then high word at stream head
    head = [state & 0xFFFFFFFF, (state >> 32) & 0xFFFFFFFF]
    stream = head + list(reversed(words))
    return b"".join(w.to_bytes(4, "little") for w in stream)


def _py_decode(data: bytes, indexes, cdfs, cdf_lengths, offsets) -> list[int]:
    words = [int.from_bytes(data[i:i + 4], "little") for i in range(0, len(data), 4)]
    if len(words) < 2:
        raise ValueError("corrupt or truncated rANS stream")
    pos = 2
    state = words[0] | (words[1] << 32)
    out = []

    def next_word():
        nonlocal pos
        if pos >= len(words):
            raise ValueError("corrupt or truncated rANS stream")
        w = words[pos]
        pos += 1
        return w

    def get_bits(nbits):
        nonlocal state
        val = state & ((1 << nbits) - 1)
        state >>= nbits
        if state < _RANS_L:
            state = (state << 32) | next_word()
        return val

    for idx in indexes:
        cdf = cdfs[idx]
        max_value = int(cdf_lengths[idx]) - 2
        cum = state & ((1 << PRECISION) - 1)
        s = 0
        while s < cdf_lengths[idx] - 1 and cdf[s + 1] <= cum:
            s += 1
        freq = int(cdf[s + 1] - cdf[s])
        state = freq * (state >> PRECISION) + cum - int(cdf[s])
        if state < _RANS_L:
            state = (state << 32) | next_word()
        value = s
        if value == max_value:
            val = get_bits(BYPASS_PRECISION)
            n_bypass = val
            while val == MAX_BYPASS_VAL:
                val = get_bits(BYPASS_PRECISION)
                n_bypass += val
            if n_bypass > 16:  # 9 chunks cover the int32 domain (native too)
                raise ValueError("corrupt or truncated rANS stream")
            raw_val = 0
            for j in range(n_bypass):
                raw_val |= get_bits(BYPASS_PRECISION) << (j * BYPASS_PRECISION)
            value = raw_val >> 1
            if raw_val & 1:
                value = -value - 1
            else:
                value += max_value
        out.append(value + int(offsets[idx]))
    return out


def _py_pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    pmf = np.asarray(pmf, dtype=np.float64)
    if np.any(~np.isfinite(pmf)) or np.any(pmf < 0):
        raise ValueError("invalid pmf")
    n = len(pmf)
    cdf = np.zeros(n + 1, dtype=np.uint64)
    # round half away from zero, like C lround
    cdf[1:] = np.floor(pmf * (1 << precision) + 0.5).astype(np.uint64)
    total = int(cdf.sum())
    if total == 0:
        raise ValueError("pmf must have non-zero mass")
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf).astype(np.int64)
    cdf[-1] = 1 << precision
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            if len(candidates) == 0:
                raise ValueError("cannot repair cdf")
            best_steal = candidates[np.argmin(freqs[candidates])]
            if best_steal < i:
                cdf[best_steal + 1:i + 1] -= 1
            else:
                cdf[i + 1:best_steal + 1] += 1
    return cdf.astype(np.int32)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class RansCodec:
    """Entropy codec over per-index quantized CDF tables.

    Parameters mirror the reference coder contract: ``cdfs`` is an
    ``(n_cdfs, max_len)`` int32 table, ``cdf_lengths`` the valid row lengths,
    ``offsets`` the per-row symbol offsets.
    """

    def __init__(self, cdfs, cdf_lengths, offsets, n_threads: int | None = None):
        self.cdfs = _as_i32(cdfs)
        if self.cdfs.ndim != 2:
            raise ValueError("cdfs must be 2D (n_cdfs, max_len)")
        self.cdf_lengths = _as_i32(cdf_lengths)
        self.offsets = _as_i32(offsets)
        if len(self.cdf_lengths) != len(self.cdfs) \
                or len(self.offsets) != len(self.cdfs):
            raise ValueError(
                f"cdf_lengths ({len(self.cdf_lengths)}) and offsets "
                f"({len(self.offsets)}) must match n_cdfs ({len(self.cdfs)})")
        self.n_threads = n_threads or min(16, os.cpu_count() or 1)
        self._lib = _get_lib()
        # Reused per-thread encode scratch: allocating the (generously sized)
        # output buffer fresh per call mmap/munmaps hundreds of MB per batch,
        # which triggers multi-second kernel page-management stalls on small
        # VMs. One pre-faulted buffer per thread amortizes that away.
        self._scratch = threading.local()

    def _encode_buffer(self, need: int) -> np.ndarray:
        buf = getattr(self._scratch, "buf", None)
        if buf is None or buf.size < need:
            buf = np.empty(need, dtype=np.uint8)
            buf[:: 4096] = 0  # pre-fault pages once, off the hot path
            self._scratch.buf = buf
        return buf

    def _check_indexes(self, indexes: np.ndarray):
        """Bounds-check before handing pointers to the native layer."""
        if indexes.size and (indexes.min() < 0
                             or indexes.max() >= len(self.cdfs)):
            raise IndexError(
                f"codec index out of range [0, {len(self.cdfs)}): "
                f"[{indexes.min()}, {indexes.max()}]")

    def _tables(self):
        return (_ptr(self.cdfs, ctypes.c_int32),
                _ptr(self.cdf_lengths, ctypes.c_int32),
                _ptr(self.offsets, ctypes.c_int32), self.cdfs.shape[1])

    # -- single message -----------------------------------------------------

    def encode_with_indexes(self, symbols, indexes) -> bytes:
        symbols, indexes = _as_i32(symbols).ravel(), _as_i32(indexes).ravel()
        if len(symbols) != len(indexes):
            raise ValueError(f"symbols ({len(symbols)}) and indexes "
                             f"({len(indexes)}) must have the same length")
        self._check_indexes(indexes)
        cap = 4 * (len(symbols) * 12 + 32)
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.rans_encode_with_indexes(
            _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32),
            len(symbols), *self._tables(), _ptr(out, ctypes.c_uint8), cap)
        if n < 0:
            raise RuntimeError("rANS encode overflow")
        return out[:n].tobytes()

    def decode_with_indexes(self, data: bytes, indexes) -> np.ndarray:
        indexes = _as_i32(indexes).ravel()
        self._check_indexes(indexes)
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(len(indexes), dtype=np.int32)
        rv = self._lib.rans_decode_with_indexes(
            _ptr(buf, ctypes.c_uint8), len(buf), _ptr(indexes, ctypes.c_int32),
            len(indexes), *self._tables(), _ptr(out, ctypes.c_int32))
        if rv < 0:
            raise ValueError("corrupt or truncated rANS stream")
        return out

    # -- batched ------------------------------------------------------------

    def _encode_rows(self, fn, symbols: np.ndarray,
                     indexes: np.ndarray) -> list[bytes]:
        batch, m = symbols.shape
        if batch == 0:
            return []
        per_cap = 4 * (m * 12 + 32)
        out = self._encode_buffer(batch * per_cap)
        lengths = np.empty(batch, dtype=np.int64)
        total = fn(
            _ptr(symbols, ctypes.c_int32), batch, m,
            _ptr(indexes, ctypes.c_int32), *self._tables(),
            _ptr(out, ctypes.c_uint8), per_cap, _ptr(lengths, ctypes.c_int64),
            self.n_threads)
        if total < 0:
            raise RuntimeError("rANS batch encode overflow")
        return [
            out[i * per_cap:i * per_cap + lengths[i]].tobytes()
            for i in range(batch)
        ]

    def _decode_rows(self, fn, streams: list[bytes], indexes: np.ndarray,
                     m: int) -> np.ndarray:
        batch = len(streams)
        if batch == 0:
            return np.empty((0, m), dtype=np.int32)
        byte_offsets = np.zeros(batch + 1, dtype=np.int64)
        np.cumsum([len(s) for s in streams], out=byte_offsets[1:])
        blob = np.frombuffer(b"".join(streams), dtype=np.uint8)
        out = np.empty((batch, m), dtype=np.int32)
        rv = fn(
            _ptr(blob, ctypes.c_uint8), _ptr(byte_offsets, ctypes.c_int64),
            batch, _ptr(indexes, ctypes.c_int32), m, *self._tables(),
            _ptr(out, ctypes.c_int32), self.n_threads)
        if rv < 0:
            raise ValueError(
                f"corrupt or truncated rANS stream (message {-rv - 1})")
        return out

    def encode_batch(self, symbols, indexes) -> list[bytes]:
        """Encode a (batch, m) symbol matrix; shared per-position `indexes` (m,)."""
        symbols = _as_i32(symbols)
        indexes = _as_i32(indexes).ravel()
        self._check_indexes(indexes)
        if symbols.ndim != 2:
            raise ValueError(f"symbols must be (batch, m), got {symbols.shape}")
        if len(indexes) != symbols.shape[1]:
            raise ValueError(f"indexes ({len(indexes)}) must match the "
                             f"symbol row length ({symbols.shape[1]})")
        return self._encode_rows(self._lib.rans_encode_batch, symbols,
                                 indexes)

    def decode_batch(self, streams: list[bytes], indexes) -> np.ndarray:
        """Decode a list of streams to a (batch, m) symbol matrix."""
        indexes = _as_i32(indexes).ravel()
        self._check_indexes(indexes)
        return self._decode_rows(self._lib.rans_decode_batch, streams,
                                 indexes, len(indexes))

    def encode_batch_varidx(self, symbols, indexes) -> list[bytes]:
        """Per-message index rows: symbols (B, m), indexes (B, m)."""
        symbols, indexes = _as_i32(symbols), _as_i32(indexes)
        self._check_indexes(indexes)
        if symbols.shape != indexes.shape or symbols.ndim != 2:
            raise ValueError(f"symbols {symbols.shape} and indexes "
                             f"{indexes.shape} must be equal (batch, m)")
        return self._encode_rows(self._lib.rans_encode_batch_varidx,
                                 symbols, indexes)

    def decode_batch_varidx(self, streams: list[bytes],
                            indexes) -> np.ndarray:
        """Decode message i against index row i of `indexes` (B, m)."""
        indexes = _as_i32(indexes)
        self._check_indexes(indexes)
        if indexes.ndim != 2:
            raise ValueError(f"indexes must be (batch, m), got "
                             f"{indexes.shape}")
        batch, m = indexes.shape
        if len(streams) != batch:
            raise ValueError(f"{len(streams)} streams but indexes has "
                             f"{batch} rows")
        return self._decode_rows(self._lib.rans_decode_batch_varidx,
                                 streams, indexes, m)


def pmf_to_quantized_cdf(pmf, precision: int = PRECISION) -> np.ndarray:
    """Quantize a PMF (tail mass appended) to an integer CDF summing to 2^precision."""
    pmf32 = np.ascontiguousarray(pmf, dtype=np.float32)
    out = np.empty(len(pmf32) + 1, dtype=np.int32)
    rv = _get_lib().pmf_to_quantized_cdf(
        _ptr(pmf32, ctypes.c_float), len(pmf32), precision,
        _ptr(out, ctypes.c_int32))
    if rv != 0:
        raise ValueError(f"invalid pmf (code {rv})")
    return out
