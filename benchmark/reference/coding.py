"""Plain entropy coding of the hub's factorized prior: CDF tables and a
rANS decoder.

Written from the published algorithms, not from the program:

* the tables are CompressAI's `EntropyBottleneck.update()` (1.1.x): the
  learned CDF's logits evaluated in float32 at the integer offsets of the
  support from `ceil` of the quantiles about the median, the pmf as the
  sign-conditional sigmoid difference, the tail mass appended, and
  `pmf_to_quantized_cdf` (CompressAI's C++: `round` of pmf * 2**16 in
  float32, rescale to the total, partial sums, then the repair that steals
  one count from the smallest frequency above 1 for every empty symbol);
* the decoder is ryg's 64-bit rANS with 32-bit renormalisation words, 16
  bits of precision and CompressAI's 4-bit bypass escape for symbols
  outside the table, decoding many streams at once with numpy.

The rate parameters are the ones the benchmark made from its seed; nothing
here reads the program's tables or codec.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

PRECISION = 16
BYPASS_BITS = 4
BYPASS_MAX = (1 << BYPASS_BITS) - 1
RANS_L = 1 << 31


def _logits_cdf(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The factorized prior's CDF logits at x of shape (C, 1, N), float32."""
    n = sum(1 for k in p if k.startswith("matrix"))
    u = x
    for i in range(n):
        u = torch.matmul(torch.nn.functional.softplus(p[f"matrix{i}"]), u) \
            + p[f"bias{i}"]
        if i < n - 1:
            u = u + torch.tanh(p[f"factor{i}"]) * torch.tanh(u)
    return u


def pmf_to_quantized_cdf(pmf: np.ndarray) -> np.ndarray:
    """CompressAI's `pmf_to_quantized_cdf` over a float32 pmf."""
    pmf = np.asarray(pmf, np.float32)
    # pmf * 2**16 is exact in float32; std::round takes halves away from 0
    cdf = [0] + [int(np.floor(np.float64(v) * (1 << PRECISION) + 0.5))
                 for v in pmf]
    total = sum(cdf)
    cdf = [((1 << PRECISION) * c) // total for c in cdf]
    for i in range(1, len(cdf)):
        cdf[i] += cdf[i - 1]
    cdf[-1] = 1 << PRECISION
    for i in range(len(cdf) - 1):
        if cdf[i] == cdf[i + 1]:
            best_freq, best = None, -1
            for j in range(len(cdf) - 1):
                f = cdf[j + 1] - cdf[j]
                if f > 1 and (best_freq is None or f < best_freq):
                    best_freq, best = f, j
            if best < 0:
                raise ValueError("cannot repair the quantized cdf")
            if best < i:
                for j in range(best + 1, i + 1):
                    cdf[j] -= 1
            else:
                for j in range(i + 1, best + 1):
                    cdf[j] += 1
    return np.asarray(cdf, np.int64)


def cdf_tables(rate_params: dict):
    """(cdfs list of int64 arrays, offsets (C,), medians (C,) float32) of
    the factorized prior, as CompressAI's `update()` builds them."""
    p = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
         rate_params.items()}
    q = p["quantiles"]
    med = q[:, 0, 1]
    minima = torch.clamp(torch.ceil(med - q[:, 0, 0]).int(), min=0)
    maxima = torch.clamp(torch.ceil(q[:, 0, 2] - med).int(), min=0)
    start = med - minima.float()
    length = maxima + minima + 1
    samples = torch.arange(int(length.max())).float()[None, None, :] \
        + start[:, None, None]
    lower = _logits_cdf(p, samples - 0.5)
    upper = _logits_cdf(p, samples + 0.5)
    sign = -torch.sign(lower + upper)
    pmf = torch.abs(torch.sigmoid(sign * upper)
                    - torch.sigmoid(sign * lower))[:, 0, :]
    tail = torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])
    cdfs = []
    for c in range(pmf.shape[0]):
        row = np.concatenate([pmf[c, :int(length[c])].numpy(),
                              tail[c:c + 1].numpy()])
        cdfs.append(pmf_to_quantized_cdf(row))
    return cdfs, (-minima).numpy().astype(np.int64), med.numpy()


def read_records(path) -> list[bytes]:
    """The records of a dataset file: a big-endian uint32 count, then each
    record as a big-endian uint32 length and its bytes."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from(">I", data, 0)
    pos, out = 4, []
    for _ in range(n):
        (size,) = struct.unpack_from(">I", data, pos)
        pos += 4
        out.append(data[pos:pos + size])
        pos += size
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the last record")
    return out


class _Streams:
    """Many rANS streams decoded in lock step: one state and one read
    position each."""

    def __init__(self, streams: list[bytes]):
        n_words = np.array([len(s) // 4 for s in streams], np.int64)
        self.bad = np.array([len(s) % 4 != 0 or len(s) < 8 for s in streams])
        width = max(int(n_words.max()), 2) + 1
        words = np.zeros((len(streams), width), np.uint64)
        for i, s in enumerate(streams):
            if not self.bad[i]:
                words[i, :n_words[i]] = np.frombuffer(s, "<u4")
        self.words, self.n_words = words, n_words
        self.state = words[:, 0] | (words[:, 1] << np.uint64(32))
        self.pos = np.full(len(streams), 2, np.int64)

    def renorm(self, rows):
        low = self.state[rows] < np.uint64(RANS_L)
        if low.any():
            r = rows[low]
            over = self.pos[r] >= self.n_words[r]
            self.bad[r[over]] = True
            w = self.words[r, np.minimum(self.pos[r], self.words.shape[1] - 1)]
            self.state[r] = (self.state[r] << np.uint64(32)) | w
            self.pos[r] += 1

    def bits(self, row: int, n: int) -> int:
        v = int(self.state[row]) & ((1 << n) - 1)
        self.state[row] >>= np.uint64(n)
        self.renorm(np.array([row]))
        return v


def decode(streams: list[bytes], cdfs, offsets) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """(symbols (n, C) int64, bad (n,) bool): every stream decoded over the
    channels in order; a stream is bad when it is malformed, reads past
    its end, or does not end where its encoder started (state 2**31, every
    word read)."""
    st = _Streams(streams)
    n, C = len(streams), len(cdfs)
    out = np.zeros((n, C), np.int64)
    rows = np.arange(n)
    mask = np.uint64((1 << PRECISION) - 1)
    for c in range(C):
        cdf = cdfs[c]
        cum = (st.state & mask).astype(np.int64)
        s = np.searchsorted(cdf, cum, side="right") - 1
        s = np.clip(s, 0, len(cdf) - 2)
        freq = (cdf[s + 1] - cdf[s]).astype(np.uint64)
        st.state = freq * (st.state >> np.uint64(PRECISION)) \
            + (cum - cdf[s]).astype(np.uint64)
        st.renorm(rows)
        value = s.copy()
        max_value = len(cdf) - 2
        for r in np.nonzero(s == max_value)[0]:
            if st.bad[r]:
                continue
            val = st.bits(r, BYPASS_BITS)
            count = val
            while val == BYPASS_MAX:
                val = st.bits(r, BYPASS_BITS)
                count += val
            if count > 16:
                st.bad[r] = True
                continue
            raw = 0
            for j in range(count):
                raw |= st.bits(r, BYPASS_BITS) << (j * BYPASS_BITS)
            value[r] = -(raw >> 1) - 1 if raw & 1 else (raw >> 1) + max_value
        out[:, c] = value + offsets[c]
    bad = st.bad | (st.state != np.uint64(RANS_L)) | (st.pos != st.n_words)
    return out, bad
