// rANS range coder with CompressAI-compatible stream layout.
//
// This is a fresh implementation of the rANS entropy coder (Duda, arXiv:1311.2540)
// in the 64-bit-state / 32-bit-renormalization variant popularized by the public
// domain ryg_rans library, using the same stream conventions as CompressAI's
// rans_interface (the codec behind the reference implementation:
// the reference's lossyless/rates.py:12-17 and hub/compressor.py:98,124):
//   * probability precision: 16 bits
//   * escape (bypass) coding for out-of-range symbols: the last CDF bin
//     (index cdf_length-2) is an escape symbol followed by 4-bit raw chunks
//   * the encoder is LIFO: symbols are buffered and emitted in reverse, the
//     final 64-bit state is flushed as two 32-bit little-endian words at the
//     head of the stream
//
// On top of the per-message codec this file adds a *batched, multithreaded*
// API (rans_encode_batch / rans_decode_batch): the reference entropy-codes one
// sample at a time from Python (hub/compressor.py:186-189, 236-238); here a
// whole batch of samples is coded in parallel across host threads while the
// accelerator computes the next batch.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread rans.cpp -o librans.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;       // probability scale bits
constexpr uint32_t kBypassPrecision = 4;  // raw-bit chunk size for escapes
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;   // lower bound of the normalization interval

// ---------------------------------------------------------------------------
// Core 64-bit rANS, 32-bit word renormalization.
// ---------------------------------------------------------------------------

struct RansEnc {
  uint64_t state = kRansL;

  // Push a symbol with cumulative start `start` and frequency `freq`
  // (scale = 1 << kPrecision). Words are written *backwards* through `ptr`.
  inline void put(uint32_t** pptr, uint32_t start, uint32_t freq) {
    uint64_t x = state;
    const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
    if (x >= x_max) {
      *(--(*pptr)) = static_cast<uint32_t>(x);
      x >>= 32;
    }
    state = ((x / freq) << kPrecision) + (x % freq) + start;
  }

  // Push `nbits` raw bits.
  inline void put_bits(uint32_t** pptr, uint32_t val, uint32_t nbits) {
    uint64_t x = state;
    const uint64_t freq = 1ull << (kPrecision - nbits);
    const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
    if (x >= x_max) {
      *(--(*pptr)) = static_cast<uint32_t>(x);
      x >>= 32;
    }
    state = (x << nbits) | val;
  }

  inline void flush(uint32_t** pptr) {
    *pptr -= 2;
    (*pptr)[0] = static_cast<uint32_t>(state >> 0);
    (*pptr)[1] = static_cast<uint32_t>(state >> 32);
  }
};

struct RansDec {
  uint64_t state = 0;
  const uint32_t* end = nullptr;  // one past the last stream word
  bool overrun = false;           // set on any read past `end`

  inline bool init(uint32_t** pptr, const uint32_t* stream_end) {
    end = stream_end;
    if (*pptr + 2 > end) {
      overrun = true;
      return false;
    }
    state = (static_cast<uint64_t>((*pptr)[1]) << 32) | (*pptr)[0];
    *pptr += 2;
    return true;
  }

  inline uint32_t get() const {
    return static_cast<uint32_t>(state & ((1u << kPrecision) - 1));
  }

  inline uint32_t next_word(uint32_t** pptr) {
    if (*pptr >= end) {
      overrun = true;
      return 0;
    }
    return *((*pptr)++);
  }

  inline void advance(uint32_t** pptr, uint32_t start, uint32_t freq) {
    const uint64_t mask = (1ull << kPrecision) - 1;
    uint64_t x = freq * (state >> kPrecision) + (state & mask) - start;
    if (x < kRansL) x = (x << 32) | next_word(pptr);
    state = x;
  }

  inline uint32_t get_bits(uint32_t** pptr, uint32_t nbits) {
    const uint32_t val = static_cast<uint32_t>(state & ((1u << nbits) - 1));
    uint64_t x = state >> nbits;
    if (x < kRansL) x = (x << 32) | next_word(pptr);
    state = x;
    return val;
  }
};

struct BufferedSym {
  uint16_t start;
  uint16_t range;
  bool bypass;  // raw-bit chunk instead of a CDF symbol
};

// Map one symbol (with escape handling) into the buffered-symbol stream.
inline void buffer_symbol(std::vector<BufferedSym>& syms, int32_t symbol,
                          const int32_t* cdf, int32_t cdf_length,
                          int32_t offset) {
  const int32_t max_value = cdf_length - 2;
  // 64-bit domain: symbol - offset and the zigzag map below would signed-
  // overflow (UB) for extreme int32 symbols (e.g. INT32_MIN latents from a
  // diverged model); the Python mirror uses arbitrary-precision ints, so
  // streams must stay identical across the full int32 symbol range
  const int64_t value64 = static_cast<int64_t>(symbol) - offset;
  int32_t value;

  uint64_t raw_val = 0;
  bool escaped = false;
  if (value64 < 0) {
    raw_val = static_cast<uint64_t>(-2 * value64 - 1);
    value = max_value;
    escaped = true;
  } else if (value64 >= max_value) {
    raw_val = static_cast<uint64_t>(2 * (value64 - max_value));
    value = max_value;
    escaped = true;
  } else {
    value = static_cast<int32_t>(value64);
  }

  syms.push_back({static_cast<uint16_t>(cdf[value]),
                  static_cast<uint16_t>(cdf[value + 1] - cdf[value]), false});

  if (escaped) {
    // number of 4-bit chunks needed for raw_val (raw_val < 2^34, so the
    // max shift is well under the uint64 width — no shift UB)
    int32_t n_bypass = 0;
    while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;

    // chunk-count in unary-ish base-15 encoding
    int32_t val = n_bypass;
    while (val >= static_cast<int32_t>(kMaxBypassVal)) {
      syms.push_back({static_cast<uint16_t>(kMaxBypassVal), 0, true});
      val -= kMaxBypassVal;
    }
    syms.push_back({static_cast<uint16_t>(val), 0, true});

    // the raw chunks, LSB first
    for (int32_t j = 0; j < n_bypass; ++j) {
      const uint32_t chunk = (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
      syms.push_back({static_cast<uint16_t>(chunk), 0, true});
    }
  }
}

// Encode buffered symbols (reverse order) into `out`; returns byte count.
int64_t flush_syms(const std::vector<BufferedSym>& syms, uint8_t* out,
                   int64_t out_capacity) {
  // worst case: one 32-bit word per buffered symbol + 2 words of final state
  std::vector<uint32_t> words(syms.size() + 2);
  uint32_t* ptr = words.data() + words.size();

  RansEnc enc;
  for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
    if (it->bypass) {
      enc.put_bits(&ptr, it->start, kBypassPrecision);
    } else {
      enc.put(&ptr, it->start, it->range);
    }
  }
  enc.flush(&ptr);

  const int64_t nbytes =
      (words.data() + words.size() - ptr) * static_cast<int64_t>(sizeof(uint32_t));
  if (nbytes > out_capacity) return -1;
  std::memcpy(out, ptr, nbytes);
  return nbytes;
}

int64_t encode_one(const int32_t* symbols, int64_t n, const int32_t* indexes,
                   const int32_t* cdfs, const int32_t* cdf_lengths,
                   const int32_t* offsets, int64_t cdf_stride, uint8_t* out,
                   int64_t out_capacity) {
  std::vector<BufferedSym> syms;
  syms.reserve(static_cast<size_t>(n) + 16);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    buffer_symbol(syms, symbols[i], cdfs + idx * cdf_stride, cdf_lengths[idx],
                  offsets[idx]);
  }
  return flush_syms(syms, out, out_capacity);
}

int64_t decode_one(const uint8_t* bytes, int64_t nbytes, const int32_t* indexes,
                   int64_t n, const int32_t* cdfs, const int32_t* cdf_lengths,
                   const int32_t* offsets, int64_t cdf_stride,
                   int32_t* out_symbols) {
  // copy to word-aligned scratch (stream length is a multiple of 4)
  std::vector<uint32_t> words((nbytes + 3) / 4);
  if (words.empty()) return -1;
  std::memcpy(words.data(), bytes, nbytes);
  uint32_t* ptr = words.data();

  RansDec dec;
  if (!dec.init(&ptr, words.data() + words.size())) return -1;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t* cdf = cdfs + idx * cdf_stride;
    const int32_t cdf_length = cdf_lengths[idx];
    const int32_t max_value = cdf_length - 2;

    const uint32_t cum = dec.get();
    // find s with cdf[s] <= cum < cdf[s+1]
    int32_t s = 0;
    while (s < cdf_length - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;

    dec.advance(&ptr, cdf[s], cdf[s + 1] - cdf[s]);

    int64_t value = s;
    if (value == max_value) {  // escape: read raw bits
      uint32_t val = dec.get_bits(&ptr, kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec.get_bits(&ptr, kBypassPrecision);
        n_bypass += val;
      }
      // 9 chunks cover the full int32 symbol domain (raw_val < 2^34); a
      // larger count can only come from a corrupt/adversarial stream — it
      // would also shift past the accumulator width, so reject it instead
      // of looping through garbage
      if (n_bypass > 16) return -1;
      uint64_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        val = dec.get_bits(&ptr, kBypassPrecision);
        raw_val |= static_cast<uint64_t>(val) << (j * kBypassPrecision);
      }
      value = static_cast<int64_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    out_symbols[i] = static_cast<int32_t>(value + offsets[idx]);
    if (dec.overrun) return -1;  // truncated/corrupt stream
  }
  return n;
}

void parallel_for(int64_t count, int64_t n_threads, void (*body)(int64_t, void*),
                  void* ctx) {
  if (n_threads <= 1 || count <= 1) {
    for (int64_t i = 0; i < count; ++i) body(i, ctx);
    return;
  }
  std::vector<std::thread> pool;
  // cyclic striping: simple + deterministic
  const int64_t workers = std::min<int64_t>(n_threads, count);
  pool.reserve(workers);
  for (int64_t t = 0; t < workers; ++t) {
    pool.emplace_back([=]() {
      for (int64_t i = t; i < count; i += workers) body(i, ctx);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// --- single message -------------------------------------------------------

int64_t rans_encode_with_indexes(const int32_t* symbols, const int32_t* indexes,
                                 int64_t n, const int32_t* cdfs,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, int64_t cdf_stride,
                                 uint8_t* out, int64_t out_capacity) {
  return encode_one(symbols, n, indexes, cdfs, cdf_lengths, offsets, cdf_stride,
                    out, out_capacity);
}

int64_t rans_decode_with_indexes(const uint8_t* bytes, int64_t nbytes,
                                 const int32_t* indexes, int64_t n,
                                 const int32_t* cdfs, const int32_t* cdf_lengths,
                                 const int32_t* offsets, int64_t cdf_stride,
                                 int32_t* out_symbols) {
  return decode_one(bytes, nbytes, indexes, n, cdfs, cdf_lengths, offsets,
                    cdf_stride, out_symbols);
}

// --- batched, threaded ----------------------------------------------------
// B independent messages of m symbols each (symbols: B*m row-major; indexes:
// shared per-position index vector of length m). Output: concatenated streams
// with per-message byte lengths. Returns total bytes, or -1 on overflow.

// index_stride: 0 = one shared index row for all messages; m = per-message
// index rows (hyperprior: indexes depend on decoded side information).

struct BatchEncCtx {
  const int32_t* symbols;
  const int32_t* indexes;
  int64_t m;
  int64_t index_stride;
  const int32_t* cdfs;
  const int32_t* cdf_lengths;
  const int32_t* offsets;
  int64_t cdf_stride;
  uint8_t* out;
  int64_t per_msg_capacity;
  int64_t* out_lengths;
};

static void batch_encode_body(int64_t i, void* vctx) {
  auto* c = static_cast<BatchEncCtx*>(vctx);
  c->out_lengths[i] = encode_one(
      c->symbols + i * c->m, c->m, c->indexes + i * c->index_stride, c->cdfs,
      c->cdf_lengths, c->offsets, c->cdf_stride,
      c->out + i * c->per_msg_capacity, c->per_msg_capacity);
}

struct BatchDecCtx {
  const uint8_t* bytes;
  const int64_t* byte_offsets;  // batch+1 prefix offsets into `bytes`
  const int32_t* indexes;
  int64_t m;
  int64_t index_stride;
  const int32_t* cdfs;
  const int32_t* cdf_lengths;
  const int32_t* offsets;
  int64_t cdf_stride;
  int32_t* out_symbols;
  int64_t* statuses;  // per-message decode_one result (-1 = corrupt)
};

static void batch_decode_body(int64_t i, void* vctx) {
  auto* c = static_cast<BatchDecCtx*>(vctx);
  c->statuses[i] = decode_one(
      c->bytes + c->byte_offsets[i],
      c->byte_offsets[i + 1] - c->byte_offsets[i],
      c->indexes + i * c->index_stride, c->m, c->cdfs, c->cdf_lengths,
      c->offsets, c->cdf_stride, c->out_symbols + i * c->m);
}

static int64_t encode_batch_impl(const int32_t* symbols, int64_t batch,
                                 int64_t m, const int32_t* indexes,
                                 int64_t index_stride, const int32_t* cdfs,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, int64_t cdf_stride,
                                 uint8_t* out, int64_t per_msg_capacity,
                                 int64_t* out_lengths, int64_t n_threads) {
  BatchEncCtx ctx{symbols, indexes, m,   index_stride, cdfs,
                  cdf_lengths, offsets, cdf_stride, out,
                  per_msg_capacity, out_lengths};
  parallel_for(batch, n_threads, batch_encode_body, &ctx);
  int64_t total = 0;
  for (int64_t i = 0; i < batch; ++i) {
    if (out_lengths[i] < 0) return -1;
    total += out_lengths[i];
  }
  return total;
}

static int64_t decode_batch_impl(const uint8_t* bytes,
                                 const int64_t* byte_offsets, int64_t batch,
                                 const int32_t* indexes, int64_t index_stride,
                                 int64_t m, const int32_t* cdfs,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, int64_t cdf_stride,
                                 int32_t* out_symbols, int64_t n_threads) {
  std::vector<int64_t> statuses(batch, 0);
  BatchDecCtx ctx{bytes, byte_offsets, indexes, m,   index_stride,
                  cdfs,  cdf_lengths,  offsets, cdf_stride, out_symbols,
                  statuses.data()};
  parallel_for(batch, n_threads, batch_decode_body, &ctx);
  for (int64_t i = 0; i < batch; ++i) {
    if (statuses[i] < 0) return -(i + 1);  // 1-based index of bad message
  }
  return batch * m;
}

int64_t rans_encode_batch(const int32_t* symbols, int64_t batch, int64_t m,
                          const int32_t* indexes, const int32_t* cdfs,
                          const int32_t* cdf_lengths, const int32_t* offsets,
                          int64_t cdf_stride, uint8_t* out,
                          int64_t per_msg_capacity, int64_t* out_lengths,
                          int64_t n_threads) {
  return encode_batch_impl(symbols, batch, m, indexes, /*index_stride=*/0,
                           cdfs, cdf_lengths, offsets, cdf_stride, out,
                           per_msg_capacity, out_lengths, n_threads);
}

int64_t rans_decode_batch(const uint8_t* bytes, const int64_t* byte_offsets,
                          int64_t batch, const int32_t* indexes, int64_t m,
                          const int32_t* cdfs, const int32_t* cdf_lengths,
                          const int32_t* offsets, int64_t cdf_stride,
                          int32_t* out_symbols, int64_t n_threads) {
  return decode_batch_impl(bytes, byte_offsets, batch, indexes,
                           /*index_stride=*/0, m, cdfs, cdf_lengths, offsets,
                           cdf_stride, out_symbols, n_threads);
}

int64_t rans_encode_batch_varidx(const int32_t* symbols, int64_t batch,
                                 int64_t m, const int32_t* indexes,
                                 const int32_t* cdfs,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, int64_t cdf_stride,
                                 uint8_t* out, int64_t per_msg_capacity,
                                 int64_t* out_lengths, int64_t n_threads) {
  return encode_batch_impl(symbols, batch, m, indexes, /*index_stride=*/m,
                           cdfs, cdf_lengths, offsets, cdf_stride, out,
                           per_msg_capacity, out_lengths, n_threads);
}

int64_t rans_decode_batch_varidx(const uint8_t* bytes,
                                 const int64_t* byte_offsets, int64_t batch,
                                 const int32_t* indexes, int64_t m,
                                 const int32_t* cdfs,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, int64_t cdf_stride,
                                 int32_t* out_symbols, int64_t n_threads) {
  return decode_batch_impl(bytes, byte_offsets, batch, indexes,
                           /*index_stride=*/m, m, cdfs, cdf_lengths, offsets,
                           cdf_stride, out_symbols, n_threads);
}

// --- pmf -> quantized cdf -------------------------------------------------
// Integer-exact conversion of a float PMF (with appended tail mass) to a
// 16-bit quantized CDF, matching the tensorflow-compression / CompressAI
// convention (reference reached via rates.py:286-305): round, rescale to
// 2^precision total, then repair zero-width bins by stealing from the
// smallest bin with frequency > 1.

int32_t pmf_to_quantized_cdf(const float* pmf, int32_t n, int32_t precision,
                             int32_t* out_cdf /* size n+1 */) {
  std::vector<uint32_t> cdf(n + 1);
  cdf[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    const float p = pmf[i];
    if (!(p >= 0.f) || !std::isfinite(p)) return -1;  // negative/NaN/inf
    cdf[i + 1] =
        static_cast<uint32_t>(std::lround(static_cast<double>(p) * (1u << precision)));
  }
  uint64_t total = 0;
  for (int32_t i = 0; i <= n; ++i) total += cdf[i];
  if (total == 0) return -2;
  for (int32_t i = 0; i <= n; ++i) {
    cdf[i] = static_cast<uint32_t>(
        (static_cast<uint64_t>(1u << precision) * cdf[i]) / total);
  }
  for (int32_t i = 1; i <= n; ++i) cdf[i] += cdf[i - 1];
  cdf[n] = 1u << precision;

  for (int32_t i = 0; i < n; ++i) {
    if (cdf[i] == cdf[i + 1]) {
      uint32_t best_freq = ~0u;
      int32_t best_steal = -1;
      for (int32_t j = 0; j < n; ++j) {
        const uint32_t freq = cdf[j + 1] - cdf[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal == -1) return -3;
      if (best_steal < i) {
        for (int32_t j = best_steal + 1; j <= i; ++j) cdf[j]--;
      } else {
        for (int32_t j = i + 1; j <= best_steal; ++j) cdf[j]++;
      }
    }
  }

  for (int32_t i = 0; i <= n; ++i) out_cdf[i] = static_cast<int32_t>(cdf[i]);
  return 0;
}

}  // extern "C"
