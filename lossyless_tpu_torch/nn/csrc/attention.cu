// Multi-head attention for short token sequences, hand-written for Hopper.
//
// K1  lossyless_fused_attention_tile (and _k5_onepass, and
//     lossyless_fused_attention for fp32 and N > 64) replaces the Pallas
//     kernel lossyless_tpu/nn/flash_attn.py::fused_attention (:211,
//     _attn_kernel :50-70): MHSA straight off the fused qkv projection,
//     (B, N, 3D) -> (B, N, D). Runs in CLIP ViT blocks 0..L-2.
// K2  lossyless_fused_attention_cls  replaces
//     lossyless_tpu/nn/flash_attn.py::fused_attention_cls (:349,
//     _attn_cls_kernel :327-345): the same attention for the class-token
//     query only, q0 (B, 1, D) and kv (B, N, 2D) -> (B, 1, D). Runs in the
//     last ViT block and the RN50 attention pool (fp32, h=32, d=64).
// K5a lossyless_fused_attention_packed (and K1's tile and one-pass tile)
//     replaces fused_attention with IMAGE_PACK > 1 (_attn_kernel_packed):
//     K1's function, which the TPU kernel computes with P consecutive
//     images' tokens stacked into one (M = P*N)-token operand per head, the
//     full M x M logits with an additive block-diagonal mask (0 within an
//     image, -1e9 across).
// K5b lossyless_fused_attention_headbatched (and K1's tiles) replaces
//     fused_attention with HEAD_BATCH (_attn_kernel_headbatched): K1's
//     function with the head a batch index inside the block (a block
//     covers all heads of the images it takes).
//
// Arithmetic (the TPU kernels', at every rounding point): q.k is
// accumulated in fp32 and multiplied by d^-1/2 AFTER the dot (K5a then adds
// the mask); row max, exp and sum in fp32; probabilities normalized as
// p / sum, rounded to the io dtype, then P.V accumulated in fp32 and stored
// in the io dtype. No flash-style rescaling of an unnormalized accumulator:
// that would move the rounding point. io dtype is bf16 or fp32, head dim
// d <= 128, N limited only by shared memory. With SOFTMAX_DTYPE=bfloat16
// K1's three designs and K2 (both io dtypes) instantiate the TPU kernels'
// bf16 softmax chain instead (kBf16Sm, `sm_logit` below); the bytes, and
// so the bounds, are the same. K5a and K5b keep fp32: JAX refuses a bf16
// softmax there, and so does the host.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the CLIP
// ViT-B/32 shapes B=512, N=50, h=12, d=64, bf16:
//   K1 reads 118.0 MB of qkv and writes 39.3 MB: 47 us from memory; its
//      3.9 GFLOP would take 4 us at the bf16 tensor-core rate. Bytes bound
//      it.
//   K2 reads 78.6 MB of kv (+0.8 MB q0) and writes 0.8 MB: 24 us; 4*B*h*N*d
//      = 0.08 GFLOP. A GEMV: bytes bound it.
//   K5a and K5b move K1's bytes and do K1's operations: 47 us from
//      memory at every pack (K5a's masked cross-image blocks add nothing to
//      the output, and the tile designs skip them).
//
// K1, K5a and K5b design, bf16 at N <= 64 with d a multiple of 16 up to 128
// and 16-byte-aligned pointers (attention_tile_kernel; the host's plans,
// flash_attn.py::k1_plan and k5_plan, pick it). About the bound: the bytes
// (47 us at the slice shape) must stream at the card's rate, so the design
// keeps several items' loads in flight with no thread spending registers or
// issue slots on them, and computes at the tensor cores' rate. Persistent:
// one block of three warpgroups on each SM walks (image, head) items in
// image-major order (item i = b * heads + h; block x takes x, x + grid,
// ...). Warpgroup 0's first thread is the producer: it issues each item's
// Q, K and V as TMA boxes of N rows x 64 columns (one 2D tensor map over
// qkv as (B*N, 3D), 128-byte swizzle; two boxes an operand where d > 64)
// into a ring of kTileStages stages (full mbarriers with the item's byte
// count, empty mbarriers a consumer's four warps arrive on). A box of N
// rows reads no byte of the next image; the pad rows N..63 of every stage
// are zeroed once and never written by TMA. The other two warpgroups are
// consumers that take alternate items (ping-pong), so one's softmax and
// stores overlap the other's products; setmaxnreg moves registers from the
// producer to them. A consumer, per item: S = Q.K^T with wgmma m64n64k16
// straight from the swizzled stage (Q as A and K as B, both K-major, d / 16
// k-steps); the scale after the dot, keys >= N set to -inf, the exact row
// max over the whole <= 64-key row (one pass, no rescaling), exp and sum in
// fp32, p = e / s (the one-pass tile's reciprocal and FMA correction)
// rounded to bf16 straight from the accumulator layout into wgmma's
// register-A layout; O = P.V with wgmma m64nXk16 (X = 64 or 128), V as an
// MN-major B operand, fp32 sums; the stage released; O rounded to bf16
// through the consumer's own swizzled output tile and stored in 16-byte
// pieces, rows < N. What it does about the one-pass tile's three limits:
// no block barrier per item (the ring's mbarriers pace the producer and
// each consumer alone, and the copies cost the consumers nothing), one
// wgmma per 64 x 64 x 16 step in place of eight mma.sync and their
// ldmatrix loads, and the padding of 50 tokens to 64 costs tensor-core
// time only, which is not what bounds it. Tile counts (head-dim k-steps)
// are compile-time.
//
// K1 design, bf16 at N <= 64 outside the tile's scope (d = 20, 33, 40, an
// input at an odd storage offset): the K5a/K5b one-pass tile below
// (k5_onepass_kernel), with the same items.
//
// K1 design, fp32 and bf16 at N > 64 (attention_kernel<T>; the first
// design, kept there: a bf16 product would not hold fp32's 1e-5). One
// block of 8 warps per (image, head). The block zero-fills its buffers and
// stages that head's Q, K and V slices as fp32 (exact for bf16 inputs),
// zero-padding rows and columns to a multiple of 4 (the pads add zeros;
// padded keys get probability 0). Each warp then takes 4 query rows at a
// time (attend_rows):
//   q.k   lane j owns key j; one float4 of K row j feeds 16 FMAs (4 rows x
//         4 columns) against float4 broadcasts of the 4 query rows. The row
//         pitch is a multiple of 4 whose quarter is odd, so the 8 lanes of a
//         quarter-warp reading rows j..j+7 hit all 32 banks.
//   softmax  warp shuffles give each row's max and sum.
//   P.V   lane owns column pairs (2*lane, +1) and (+64); float2 of V against
//         float4 broadcasts of 4 probabilities per row.
// The sums over the head dim and over the keys run in index order. Its
// staging path: 16-byte loads where d is a whole number of 16-byte chunks
// and q, k and v are 16-byte aligned; element loads otherwise.
//
// The tensor-core designs sum in the tensor cores' order, not the plain
// path's: about 1e-4 of their bf16 outputs differ from the plain
// attention's by an ulp. chip_smoke.py holds every design to the plain
// version (atol 2e-2 in bf16) and, at the slice shape, to the attention
// evaluated in float64: the share of outputs that differ from it at most
// 1.5 times the plain path's, and no output farther from it than the plain
// path's farthest plus one ulp.
//
// K2 design, both dtypes (k2_attention_kernel). One warp per (image, head)
// item, 8 warps a block, every warp computing (the first design ran one
// block per item with only warp 0 computing, its single query row padded
// to 4, K and V widened to fp32 in shared memory first). About the bound:
// every K and V byte is read once, straight from device memory into
// registers (no staging, no padded query rows), with 16-byte K-row loads
// and the V loads of 8 keys issued together, so enough bytes are in
// flight. The arithmetic keeps the first design's order: lane j computes
// the logits of keys j, j + 32, ..., each an FMA chain over the head dim in
// index order against q0 in shared memory (a broadcast); the softmax is
// the row code's (the row sum e[l] + e[l+32] + ... then an xor butterfly,
// p = e / s); then lane l accumulates output columns 2l, 2l+1 (and +64) as
// FMA chains over the keys in index order (one 4- or 8-byte load a lane a
// key: a V row's 128 bytes a warp instruction). A K2 that split each dot
// over 8 lanes and reduced it by shuffles (0.044 ms) changed 3e-5 of its
// outputs by a bf16 ulp, which moved the hyperprior path's 3-step
// training logs under the attention knobs past their 1e-2 bound: the same
// dependence on summation order as K1's (queue 3). Staging path: 16-byte
// loads where d is a whole number of 16-byte chunks and q0, kv and out are
// 16-byte aligned (the host's plan, flash_attn.py::k2_plan), else element
// loads.
//
// K5a/K5b: at bf16 N <= 64 both run K1's kernels above (the tile where it
// takes the shape, else the one-pass tile), with K1's items. K5a skips the
// masked cross-image blocks and computes each image's N x N diagonal block
// alone: a masked logit adds exp(-1e9 - max) == 0 exactly to its row's fp32
// sum and 0 * v == 0 to P.V, so this is the TPU kernel's function (as the
// note at lossyless_tpu/nn/flash_attn.py:86 says).
//
// The one-pass tile (k5_onepass_kernel; bf16, N <= 64, any d <= 128, any
// alignment; the design before the TMA/wgmma tile, 0.066 against its 0.057
// ms at the slice shape on an H100 SXM): work items are (image, head) pairs in
// image-major order; block x takes a run of per_block items (runs sized
// so 4 blocks an SM fill 132 SMs; the last run may be short, masked in the
// kernel). About the bound: every input byte crosses once through a
// cp.async ring of two stages (16-byte copies, each stage one item's Q, K
// and V at a pitch padded by 16 bytes, so ldmatrix is conflict-free; the
// next item's copies are in flight while the warps compute the current
// one; only pad rows and columns are zeroed, once a block), and the output
// leaves in 16-byte stores. A warp owns 16 query rows (onepass_tile): Q
// fragments by ldmatrix, the logits of all padded keys (<= 64) computed
// once into 32 fp32 registers with mma.sync m16n8k16, the row max over
// the whole row, exp and the sum in fp32, p = e / s (a reciprocal and one
// FMA correction) rounded to bf16 straight from the accumulator layout
// into the A-fragment layout, P.V on mma.sync in fp32, the result rounded
// to bf16 and written through the warp's own Q rows. Tile counts (16-key
// chunks, head dim padded to 32, 64 or 128) and the ring's depth are
// compile-time. Element loads and stores where d % 8 or the pointers are
// not 16-byte aligned (d = 20, 33, a view at an odd storage offset).
//
// K5a/K5b design, bf16 at N > 64 (the first, two-pass tile, kept there;
// mma_attend_tile) and fp32 (the CUDA-core row code, attend_rows; a bf16
// product would not hold fp32's 1e-5). Two-pass: a warp owns 16 query
// rows and streams them over all keys in chunks of 16, the logits never
// leaving its registers: pass 1 keeps each row's running max and sum of
// exp (rescaled when the max grows), pass 2 recomputes the chunk's logits,
// forms p = exp(l - max) / sum, rounds it to bf16 in the A-fragment layout
// and accumulates P.V. Q fragments come from device memory; K and V are
// staged in shared memory as bf16, zero-padded to a multiple of 16 in both
// dims.
//   K5a: one block per (group of P images, head). It stages the group's
//        M x d K and V and runs the full masked M x M product.
//   K5b: one block per image, all heads: the block stages the K/V of
//        `hp` heads a pass (the host's plan picks hp so that a pass fits
//        half an SM) and its warps take (head, 16-row tile) items of that
//        pass. fp32 stages Q, K and V of the pass's heads and its warps
//        take (head, 4-row) items.
//
// Every input byte is read from device memory once and every output byte
// written once; logits and probabilities never leave the SM. Measured
// times are in PERF.md (from chip_smoke.py).
//
// Interface: plain C, loaded with ctypes. Each launcher runs on the given
// stream, does not synchronise and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take, before launching).

#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarp = 32;
constexpr int kMaxD = 128;
constexpr int kRows = 4;                 // query rows per warp step (FMA)
constexpr int kMaxK16 = kMaxD / 16;      // k-steps of the q.k mma
constexpr int kMaxN8 = kMaxD / 8;        // n-tiles of the P.V mma
constexpr int kPad16 = 8;                // bf16 row-pitch pad (16 bytes)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// SOFTMAX_DTYPE (flash_attn.py's knob, JAX flash_attn.py:99-108). The
// designs of K1 and K2 take it as the compile-time flag kBf16Sm, which runs
// the TPU kernels' bf16 chain (_attn_kernel :55-69, _attn_cls_kernel
// :330-343) at each of its rounding points: the fp32 logit rounded to
// bf16, times the bf16-rounded scale, rounded; the row max; l - max
// rounded, its exp rounded; the exps summed in fp32 (jnp.sum upcasts bf16)
// and the sum rounded once; e / s rounded. The sum's order is the design's
// own. Without the flag every step is fp32 (the parity default).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16Sm>
__device__ __forceinline__ float sm_logit(float acc, float scale) {
  if constexpr (kBf16Sm)
    return bf16_round(bf16_round(acc) * bf16_round(scale));
  else
    return acc * scale;
}

template <bool kBf16Sm>
__device__ __forceinline__ float sm_exp(float l, float m) {
  if constexpr (kBf16Sm)
    return bf16_round(expf(bf16_round(l - m)));
  else
    return expf(l - m);
}

template <bool kBf16Sm>
__device__ __forceinline__ float sm_round(float x) {
  if constexpr (kBf16Sm)
    return bf16_round(x);
  else
    return x;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory carve-up, in floats: Q (nq4 rows), K and V (n4 rows), all
// with row pitch `ld`, then each warp's kRows x n4 probability rows.
struct Layout {
  int ld, nq4, n4;
  size_t k, v, p, total;
};

__host__ __device__ __forceinline__ Layout layout(int n_q, int N, int d,
                                                  int n_warps) {
  Layout L;
  L.ld = round_up(d, 4) | 4;  // multiple of 4 with ld/4 odd
  L.nq4 = round_up(n_q, kRows);
  L.n4 = round_up(N, 4);
  L.k = static_cast<size_t>(L.nq4) * L.ld;
  L.v = L.k + static_cast<size_t>(L.n4) * L.ld;
  L.p = L.v + static_cast<size_t>(L.n4) * L.ld;
  L.total = L.p + static_cast<size_t>(n_warps) * kRows * L.n4;
  return L;
}

// rows x d elements at src (row stride `stride` elements) -> fp32 tile.
// `vec`: d is a multiple of 16 bytes' worth of T and src is 16-byte aligned.
template <typename T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src,
                      int64_t stride, int rows, int d, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int per_row = d / kVec;
    for (int ch = threadIdx.x; ch < rows * per_row; ch += blockDim.x) {
      const int r = ch / per_row;
      const int c = (ch - r * per_row) * kVec;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      float4* o = reinterpret_cast<float4*>(dst + r * ld + c);
#pragma unroll
      for (int t = 0; t < kVec / 4; ++t)
        o[t] = make_float4(to_f32(e[4 * t]), to_f32(e[4 * t + 1]),
                           to_f32(e[4 * t + 2]), to_f32(e[4 * t + 3]));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
      const int r = idx / d;
      const int c = idx - r * d;
      dst[r * ld + c] = to_f32(src[r * stride + c]);
    }
  }
}

// One warp, query rows i0..i0+3 (qr: row i0 of the staged Q) against the N
// keys staged at ks/vs (fp32, pitch ld, zero-padded to n4 rows and a
// multiple of 4 columns); ps is this warp's kRows x n4 buffer. kMasked
// (K5a): queries and keys are `seg`-token images stacked, and a logit whose
// key lies in another image than its query gets -1e9 after the scale.
template <typename T, bool kMasked, bool kBf16Sm>
__device__ __forceinline__ void attend_rows(const float* qr, const float* ks,
                                            const float* vs, int ld,
                                            float* ps, int n4, int N, int d,
                                            float scale, int i0, int n_q,
                                            int seg, T* __restrict__ ob,
                                            int64_t out_row) {
  const int lane = threadIdx.x % kWarp;
  const int d4 = round_up(d, 4);

  // logits: fp32 dot over the head dim, scaled after the dot
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
  for (int j = lane; j < N; j += kWarp) {
    const float* kr = ks + j * ld;
    float acc[kRows] = {};
    for (int c = 0; c < d4; c += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + r * ld + c);
        acc[r] = fmaf(q4.x, kv4.x, acc[r]);
        acc[r] = fmaf(q4.y, kv4.y, acc[r]);
        acc[r] = fmaf(q4.z, kv4.z, acc[r]);
        acc[r] = fmaf(q4.w, kv4.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float l = sm_logit<kBf16Sm>(acc[r], scale);
      if (kMasked && (i0 + r) / seg != j / seg) l += -1e9f;
      ps[r * n4 + j] = l;
      m[r] = fmaxf(m[r], l);
    }
  }
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = warp_max(m[r]);
    s[r] = 0.f;
  }
  for (int j = lane; j < N; j += kWarp) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float e = sm_exp<kBf16Sm>(ps[r * n4 + j], m[r]);
      ps[r * n4 + j] = e;
      s[r] += e;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = sm_round<kBf16Sm>(warp_sum(s[r]));
  // normalize, round to the io dtype; the padding keys get probability 0
  for (int j = lane; j < n4; j += kWarp) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      ps[r * n4 + j] =
          j < N ? to_f32(from_f32<T>(sm_round<kBf16Sm>(ps[r * n4 + j] / s[r])))
                : 0.f;
  }
  __syncwarp();

  // P.V: this lane's output columns are (c, c+1) for c = 2*lane, 2*lane+64
  float2 o[kRows][2] = {};
  for (int j = 0; j < n4; j += 4) {
    float4 p4[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      p4[r] = *reinterpret_cast<const float4*>(ps + r * n4 + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* vr = vs + (j + jj) * ld;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = 2 * lane + 64 * t;
        if (c < d) {
          const float2 v2 = *reinterpret_cast<const float2*>(vr + c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = lane_of(p4[r], jj);
            o[r][t].x = fmaf(p, v2.x, o[r][t].x);
            o[r][t].y = fmaf(p, v2.y, o[r][t].y);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (i0 + r >= n_q) break;
    T* orow = ob + (i0 + r) * out_row;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = 2 * lane + 64 * t;
      if (c < d) orow[c] = from_f32<T>(o[r][t].x);
      if (c + 1 < d) orow[c + 1] = from_f32<T>(o[r][t].y);
    }
  }
  __syncwarp();  // ps is rewritten by this warp's next step
}

// One (image or group, head) block: stage Q, K, V of the head, then each
// warp takes 4 query rows at a time. blockIdx.x = image (group), blockIdx.y
// = head h. q/k/v/out point at head 0 of image 0; the *_batch strides step
// images, the *_row strides tokens.
template <typename T, bool kMasked, bool kBf16Sm>
__device__ __forceinline__ void attention_block(
    const T* __restrict__ q, int64_t q_batch, int64_t q_row, int n_q,
    const T* __restrict__ k, const T* __restrict__ v, int64_t kv_batch,
    int64_t kv_row, T* __restrict__ out, int64_t out_batch, int64_t out_row,
    int N, int d, float scale, bool vec, int seg) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const Layout L = layout(n_q, N, d, n_warps);
  float* qs = smem;
  float* ks = smem + L.k;
  float* vs = smem + L.v;
  float* ps = smem + L.p + static_cast<size_t>(warp) * kRows * L.n4;

  // the padding rows and columns of Q, K and V must read as zero
  for (size_t i = threadIdx.x; i < L.p; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  const int64_t b = blockIdx.x;
  const int64_t hd = static_cast<int64_t>(blockIdx.y) * d;
  stage(qs, L.ld, q + b * q_batch + hd, q_row, n_q, d, vec);
  stage(ks, L.ld, k + b * kv_batch + hd, kv_row, N, d, vec);
  stage(vs, L.ld, v + b * kv_batch + hd, kv_row, N, d, vec);
  __syncthreads();
  T* ob = out + b * out_batch + hd;
  for (int i0 = warp * kRows; i0 < n_q; i0 += n_warps * kRows)
    attend_rows<T, kMasked, kBf16Sm>(qs + i0 * L.ld, ks, vs, L.ld, ps, L.n4,
                                     N, d,
                            scale, i0, n_q, seg, ob, out_row);
}

// K1.
template <typename T, bool kBf16Sm>
__global__ void attention_kernel(const T* __restrict__ q, int64_t q_batch,
                                 int64_t q_row, int n_q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, int64_t kv_batch,
                                 int64_t kv_row, T* __restrict__ out,
                                 int64_t out_batch, int64_t out_row, int N,
                                 int d, float scale, bool vec, int seg) {
  attention_block<T, false, kBf16Sm>(q, q_batch, q_row, n_q, k, v, kv_batch,
                                     kv_row, out, out_batch, out_row, N, d,
                                     scale, vec, 0);
}

// K5a on the CUDA cores (fp32): blockIdx.x is a group of images whose
// M = P*N tokens form one operand; `seg` = N tokens per image.
template <typename T>
__global__ void packed_attention_fma_kernel(
    const T* __restrict__ q, int64_t q_batch, int64_t q_row, int n_q,
    const T* __restrict__ k, const T* __restrict__ v, int64_t kv_batch,
    int64_t kv_row, T* __restrict__ out, int64_t out_batch, int64_t out_row,
    int N, int d, float scale, bool vec, int seg) {
  attention_block<T, true, false>(q, q_batch, q_row, n_q, k, v, kv_batch,
                                  kv_row, out, out_batch, out_row, N, d,
                                  scale, vec, seg);
}

// K5b on the CUDA cores (fp32): blockIdx.x = image b. Passes of `hp`
// heads: stage their Q, K, V (per head: a Layout's Q, K, V regions), then
// the warps take (head, 4-row) items of the pass.
template <typename T>
__global__ void headbatched_attention_fma_kernel(const T* __restrict__ qkv,
                                                 T* __restrict__ out, int N,
                                                 int heads, int d,
                                                 float scale, int hp,
                                                 bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const Layout L = layout(N, N, d, n_warps);
  float* ps = smem + hp * L.p + static_cast<size_t>(warp) * kRows * L.n4;
  const int64_t D = static_cast<int64_t>(heads) * d;
  const T* base = qkv + static_cast<int64_t>(blockIdx.x) * N * 3 * D;
  T* ob = out + static_cast<int64_t>(blockIdx.x) * N * D;
  const int groups = (N + kRows - 1) / kRows;

  for (size_t i = threadIdx.x; i < hp * L.p; i += blockDim.x) smem[i] = 0.f;
  for (int h0 = 0; h0 < heads; h0 += hp) {
    const int nh = min(hp, heads - h0);
    __syncthreads();  // the zero fill, or the previous pass, is done
    for (int hh = 0; hh < nh; ++hh) {
      float* r = smem + hh * L.p;
      const T* src = base + static_cast<int64_t>(h0 + hh) * d;
      stage(r, L.ld, src, 3 * D, N, d, vec);
      stage(r + L.k, L.ld, src + D, 3 * D, N, d, vec);
      stage(r + L.v, L.ld, src + 2 * D, 3 * D, N, d, vec);
    }
    __syncthreads();
    for (int it = warp; it < nh * groups; it += n_warps) {
      const int hh = it / groups;
      const int i0 = (it - hh * groups) * kRows;
      const float* r = smem + hh * L.p;
      attend_rows<T, false, false>(r + i0 * L.ld, r + L.k, r + L.v, L.ld, ps,
                                   L.n4,
                            N, d, scale, i0, N, 0,
                            ob + static_cast<int64_t>(h0 + hh) * d, D);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): mma.sync m16n8k16, bf16 in, fp32 accumulate.
// ---------------------------------------------------------------------------

// B fragment (k 16 x n 8) from a [n][k] row-major tile at p (K rows).
__device__ __forceinline__ void load_b_nk(uint32_t b[2], const bf16* p,
                                          int pitch) {
  const int lane = threadIdx.x & 15;
  const bf16* row = p + (lane & 7) * pitch + (lane >> 3) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_addr(row)));
}

// B fragment (k 16 x n 8) from a [k][n] row-major tile at p (V rows),
// transposed on load.
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const bf16* p,
                                          int pitch) {
  const int lane = threadIdx.x & 15;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_addr(p + lane * pitch)));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc = q-tile (16 x d16) . K[kc .. kc+15]^T: two 16 x 8 n-tiles of keys.
__device__ __forceinline__ void logits16(float acc[2][4],
                                         uint32_t qa[kMaxK16][4],
                                         const bf16* kc, int ld, int nk) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxK16; ++kk) {
    if (kk < nk) {
      uint32_t b0[2], b1[2];
      load_b_nk(b0, kc + kk * 16, ld);
      load_b_nk(b1, kc + 8 * ld + kk * 16, ld);
      mma(acc[0], qa[kk], b0);
      mma(acc[1], qa[kk], b1);
    }
  }
}

// One warp: query rows r0..r0+15 of one head against the M keys staged in
// ks/vs (bf16, pitch ld, zero-padded to mp rows and a multiple of 16
// columns). q/out point at the head's columns of token row 0; rows step
// q_row / out_row elements. Accumulator element e of n-tile j sits at row
// g + 8*(e >> 1), key 8*j + 2*t + (e & 1) of the chunk (g = lane / 4,
// t = lane % 4). kMasked (K5a): `seg`-token images stacked; a logit across
// images gets -1e9 after the scale.
template <bool kMasked>
__device__ __forceinline__ void mma_attend_tile(
    const bf16* __restrict__ q, int64_t q_row, const bf16* ks,
    const bf16* vs, int ld, int r0, int M, int mp, int d, float scale,
    int seg, bf16* __restrict__ out, int64_t out_row) {
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (d + 15) / 16;
  const int nn = (d + 7) / 8;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the tile's A fragments from device memory: register e holds row
  // g + 8*(e & 1), columns 2t + 8*(e >> 1) and the next one
  uint32_t qa[kMaxK16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxK16; ++kk) {
    if (kk < nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        const int col = kk * 16 + 2 * t + 8 * (e >> 1);
        bf16 lo = zero, hi = zero;
        if (row < M) {
          const bf16* src = q + row * q_row + col;
          if (col < d) lo = src[0];
          if (col + 1 < d) hi = src[1];
        }
        qa[kk][e] = pack_bf16(lo, hi);
      }
    }
  }

  auto logit = [&](float acc, int row, int col) -> float {
    if (col >= M) return -INFINITY;  // padding key
    float l = acc * scale;
    if (kMasked && row / seg != col / seg) l += -1e9f;
    return l;
  };

  // pass 1: each row's max and sum of exp over all keys, online
  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
  for (int kc = 0; kc < mp; kc += 16) {
    float acc[2][4];
    logits16(acc, qa, ks + kc * ld, ld, nk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      float l[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          l[2 * j + c] = logit(acc[j][2 * h + c], row, kc + 8 * j + 2 * t + c);
      float cm = fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float mn = fmaxf(m[h], cm);  // finite from the first chunk on
      s[h] = s[h] * expf(m[h] - mn) + ((expf(l[0] - mn) + expf(l[1] - mn)) +
                                       (expf(l[2] - mn) + expf(l[3] - mn)));
      m[h] = mn;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }

  // pass 2: p = exp(l - max) / sum rounded to bf16, then P.V
  float o[kMaxN8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxN8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int kc = 0; kc < mp; kc += 16) {
    float acc[2][4];
    logits16(acc, qa, ks + kc * ld, ld, nk);
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float l = logit(acc[j][e], r0 + g + 8 * h,
                              kc + 8 * j + 2 * t + (e & 1));
        p[j][e] = expf(l - m[h]) / s[h];
      }
    // the accumulator layout of the two key n-tiles is the A-fragment
    // layout of one 16-key k-step
    const uint32_t pa[4] = {pack_f32(p[0][0], p[0][1]),
                            pack_f32(p[0][2], p[0][3]),
                            pack_f32(p[1][0], p[1][1]),
                            pack_f32(p[1][2], p[1][3])};
#pragma unroll
    for (int nt = 0; nt < kMaxN8; ++nt) {
      if (nt < nn) {
        uint32_t b[2];
        load_b_kn(b, vs + kc * ld + nt * 8, ld);
        mma(o[nt], pa, b);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kMaxN8; ++nt) {
    if (nt >= nn) break;
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row >= M) continue;
      bf16* orow = out + row * out_row;
      if (col < d) orow[col] = __float2bfloat16_rn(o[nt][2 * h]);
      if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(o[nt][2 * h + 1]);
    }
  }
}

// rows x d bf16 at src (row stride `stride`) -> bf16 tile at pitch ld.
// `vec`: d % 8 == 0 and src 16-byte aligned.
__device__ void stage_bf16(bf16* dst, int ld, const bf16* __restrict__ src,
                           int64_t stride, int rows, int d, bool vec) {
  if (vec) {
    const int per_row = d / 8;
    for (int ch = threadIdx.x; ch < rows * per_row; ch += blockDim.x) {
      const int r = ch / per_row;
      const int c = (ch - r * per_row) * 8;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
      const int r = idx / d;
      const int c = idx - r * d;
      dst[r * ld + c] = src[r * stride + c];
    }
  }
}

__device__ void zero_smem(void* p, size_t bytes) {  // bytes % 16 == 0
  uint4* q = static_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

struct MmaLayout {
  int d16, ld, mp;
  size_t tile;  // bf16 elements of one K (or V) tile
};

__host__ __device__ __forceinline__ MmaLayout mma_layout(int M, int d) {
  MmaLayout L;
  L.d16 = round_up(d, 16);
  L.ld = L.d16 + kPad16;
  L.mp = round_up(M, 16);
  L.tile = static_cast<size_t>(L.mp) * L.ld;
  return L;
}

// K5a on the tensor cores (bf16): blockIdx.x = group of `pack` images,
// blockIdx.y = head.
__global__ void packed_attention_mma_kernel(const bf16* __restrict__ qkv,
                                            bf16* __restrict__ out, int N,
                                            int pack, int heads, int d,
                                            float scale, bool vec) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  const int M = pack * N;
  const MmaLayout L = mma_layout(M, d);
  bf16* ks = smem_bf16;
  bf16* vs = smem_bf16 + L.tile;
  const int64_t D = static_cast<int64_t>(heads) * d;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * M;
  const int64_t hd = static_cast<int64_t>(blockIdx.y) * d;
  const bf16* q = qkv + row0 * 3 * D + hd;

  zero_smem(smem_bf16, 2 * L.tile * sizeof(bf16));
  __syncthreads();
  stage_bf16(ks, L.ld, q + D, 3 * D, M, d, vec);
  stage_bf16(vs, L.ld, q + 2 * D, 3 * D, M, d, vec);
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int r0 = warp * 16; r0 < M; r0 += n_warps * 16)
    mma_attend_tile<true>(q, 3 * D, ks, vs, L.ld, r0, M, L.mp, d, scale, N,
                          out + row0 * D + hd, D);
}

// K5b on the tensor cores (bf16): blockIdx.x = image b. Passes of `hp`
// heads: stage their K and V, then the warps take (head, 16-row tile) items.
__global__ void headbatched_attention_mma_kernel(const bf16* __restrict__ qkv,
                                                 bf16* __restrict__ out,
                                                 int N, int heads, int d,
                                                 float scale, int hp,
                                                 bool vec) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  const MmaLayout L = mma_layout(N, d);
  const int64_t D = static_cast<int64_t>(heads) * d;
  const bf16* base = qkv + static_cast<int64_t>(blockIdx.x) * N * 3 * D;
  bf16* ob = out + static_cast<int64_t>(blockIdx.x) * N * D;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int tiles = (N + 15) / 16;

  zero_smem(smem_bf16, 2 * hp * L.tile * sizeof(bf16));
  for (int h0 = 0; h0 < heads; h0 += hp) {
    const int nh = min(hp, heads - h0);
    __syncthreads();  // the zero fill, or the previous pass, is done
    for (int hh = 0; hh < nh; ++hh) {
      const bf16* src = base + static_cast<int64_t>(h0 + hh) * d;
      bf16* ks = smem_bf16 + 2 * hh * L.tile;
      stage_bf16(ks, L.ld, src + D, 3 * D, N, d, vec);
      stage_bf16(ks + L.tile, L.ld, src + 2 * D, 3 * D, N, d, vec);
    }
    __syncthreads();
    for (int it = warp; it < nh * tiles; it += n_warps) {
      const int hh = it / tiles;
      const int r0 = (it - hh * tiles) * 16;
      const bf16* ks = smem_bf16 + 2 * hh * L.tile;
      const int64_t hd = static_cast<int64_t>(h0 + hh) * d;
      mma_attend_tile<false>(base + hd, 3 * D, ks, ks + L.tile, L.ld, r0, N,
                             L.mp, d, scale, 0, ob + hd, D);
    }
  }
}

// ---------------------------------------------------------------------------
// K5a/K5b one-pass tile (bf16, N <= 64, d <= 128): see the note at the top
// ---------------------------------------------------------------------------

constexpr int kOnePassMaxN = 64;
constexpr int kStages = 2;  // ring stages: one item lands while one computes

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Head-dim class of the one-pass tile: d is zero-padded to 32, 64 or 128
// columns (compile-time k-steps; the pad columns add zeros).
__host__ __device__ __forceinline__ int onepass_d16(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : 8;
}

// Stage item (b, h)'s Q, K and V (N x d each) into one ring stage: three
// tiles of `tile` elements at pitch ld. `vec`: cp.async 16-byte copies
// (d % 8 == 0, qkv 16-byte aligned), the thread's chunks stepped without
// divisions (it starts at row r, chunk c of the row and steps dr rows and
// dc chunks: the block's threads in row-major chunk order); else element
// loads.
__device__ __forceinline__ void onepass_stage(bf16* st, int ld, int tile,
                                              const bf16* __restrict__ qkv,
                                              int64_t D, int N, int d,
                                              int b, int h, bool vec, int r,
                                              int c, int dr, int dc) {
  const bf16* src = qkv + static_cast<int64_t>(b) * N * 3 * D +
                    static_cast<int64_t>(h) * d;
  const int row = static_cast<int>(3 * D);  // token stride in the image
  const int k_off = static_cast<int>(D);
  if (vec) {
    const int per_row = d / 8;
    while (r < N) {
      const int g = r * row + c * 8;
      const int s = r * ld + c * 8;
      cp_async16(st + s, src + g);
      cp_async16(st + tile + s, src + k_off + g);
      cp_async16(st + 2 * tile + s, src + 2 * k_off + g);
      r += dr;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < 3; ++m)
      for (int e = threadIdx.x; e < N * d; e += blockDim.x) {
        const int rr = e / d;
        const int col = e - rr * d;
        st[m * tile + rr * ld + col] = src[rr * row + m * k_off + col];
      }
  }
}

// One warp: the 16 query rows r0.. of one (image, head) whose Q, K and V
// sit in shared memory (qs: row r0 of Q; ks, vs: key 0), zero-padded to
// kKC*16 rows and kD16*16 columns at pitch kLd. Accumulator element e of
// n-tile j sits at row g + 8*(e >> 1), column 8*j + 2*t + (e & 1)
// (g = lane / 4, t = lane % 4). The output leaves through the warp's own Q
// rows (its Q fragments are in registers by then): 16-byte stores where
// `vec`, else element stores from the fragments.
template <int kKC, int kD16, bool kBf16Sm>
__device__ __forceinline__ void onepass_tile(bf16* qs, const bf16* ks,
                                             const bf16* vs, int N, int d,
                                             float scale, int r0,
                                             bf16* __restrict__ out,
                                             int64_t out_row, bool vec) {
  constexpr int kLd = kD16 * 16 + kPad16;
  constexpr int kNT = 2 * kKC;   // n-tiles of 8 keys
  constexpr int kDT = 2 * kD16;  // n-tiles of 8 output columns
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;

  // logits of all kKC*16 padded keys, once, into registers
  float l[kNT][4];
  {
    uint32_t qa[kD16][4];
    const bf16* qrow = qs + (lane & 15) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk) ldsm_x4(qa[kk], qrow + kk * 16);
    const bf16* krow =
        ks + ((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) l[2 * kc][e] = l[2 * kc + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, krow + kc * 16 * kLd + kk * 16);
        mma(l[2 * kc], qa[kk], b);
        mma(l[2 * kc + 1], qa[kk], b + 2);
      }
    }
  }

  // softmax over the whole row (fp32, or the bf16 chain): scale after the
  // dot, padded keys -inf
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      l[j][e] = col < N ? sm_logit<kBf16Sm>(l[j][e], scale) : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], l[j][e]);
    }
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      l[j][e] = sm_exp<kBf16Sm>(l[j][e], m[e >> 1]);
      s[e >> 1] += l[j][e];
    }
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    s[h] = sm_round<kBf16Sm>(s[h]);
    rs[h] = __frcp_rn(s[h]);
  }

  // P.V: p = e / s (a reciprocal and one FMA correction: the quotient),
  // rounded to bf16 straight into the A-fragment layout
  float o[kDT][4];
#pragma unroll
  for (int nt = 0; nt < kDT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const bf16* vrow = vs + (lane & 15) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = l[2 * kc + j][e], sv = s[e >> 1], r = rs[e >> 1];
        const float q = ev * r;
        p[j][e] = fmaf(fmaf(-q, sv, ev), r, q);
      }
    const uint32_t pa[4] = {pack_f32(p[0][0], p[0][1]),
                            pack_f32(p[0][2], p[0][3]),
                            pack_f32(p[1][0], p[1][1]),
                            pack_f32(p[1][2], p[1][3])};
#pragma unroll
    for (int np = 0; np < kD16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + kc * 16 * kLd + np * 16);
      mma(o[2 * np], pa, b);
      mma(o[2 * np + 1], pa, b + 2);
    }
  }

  if (vec) {  // through the warp's Q rows, then 16-byte stores
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = g + 8 * h;
        if (col < d && r0 + rr < N)
          *reinterpret_cast<uint32_t*>(qs + rr * kLd + col) =
              pack_f32(o[nt][2 * h], o[nt][2 * h + 1]);
      }
    }
    __syncwarp();
    const int per_row = d / 8;
    for (int c = lane; c < 16 * per_row; c += kWarp) {
      const int rr = c / per_row;
      const int col = (c - rr * per_row) * 8;
      if (r0 + rr < N)
        *reinterpret_cast<uint4*>(out + (r0 + rr) * out_row + col) =
            *reinterpret_cast<const uint4*>(qs + rr * kLd + col);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        if (row >= N) continue;
        bf16* orow = out + row * out_row;
        if (col < d) orow[col] = __float2bfloat16_rn(o[nt][2 * h]);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(o[nt][2 * h + 1]);
      }
    }
  }
}

// The one-pass tile (bf16, N <= 64; K1, K5a and K5b): block x takes the
// run of work items [x * per_block, ...) (item i is image i / heads, head
// i % heads; the last run may be short). kKC warps, one a 16-row tile of
// the item. A ring of kStages stages, each Q, K and V of one item: the
// copies of the next kStages - 1 items are in flight while the warps
// compute the current one.
template <int kKC, int kD16, bool kBf16Sm>
__global__ void __launch_bounds__(kKC* kWarp, kD16 <= 4 ? 4 : 2)
    k5_onepass_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      int B, int N, int heads, int d, float scale,
                      int per_block, bool vec) {
  extern __shared__ __align__(16) bf16 smem_bf16[];
  constexpr int kLd = kD16 * 16 + kPad16;
  constexpr int kTile = kKC * 16 * kLd;
  const int64_t D = static_cast<int64_t>(heads) * d;
  const int first = blockIdx.x * per_block;
  const int count = min(per_block, B * heads - first);
  if (count <= 0) return;  // the whole block: nothing below has run
  const int warp = threadIdx.x / kWarp;

  // zero the pad rows and columns of every tile, once; copies never
  // write there
  for (int z = 0; z < 3 * kStages; ++z) {
    bf16* tile = smem_bf16 + z * kTile;
    uint4* rows = reinterpret_cast<uint4*>(tile + N * kLd);
    for (int i = threadIdx.x; i < (kKC * 16 - N) * kLd / 8; i += blockDim.x)
      rows[i] = make_uint4(0u, 0u, 0u, 0u);
    const int pad = kD16 * 16 - d;
    for (int i = threadIdx.x; i < N * pad; i += blockDim.x) {
      const int r = i / pad;
      tile[r * kLd + d + (i - r * pad)] = __float2bfloat16_rn(0.f);
    }
  }

  // this thread's first 16-byte chunk and its step (vec path)
  const int per_row = max(d / 8, 1);
  const int r0 = threadIdx.x / per_row, c0 = threadIdx.x - r0 * per_row;
  const int dr = blockDim.x / per_row, dc = blockDim.x - dr * per_row;
  int b, h;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) {
      b = (first + i) / heads;
      h = first + i - b * heads;
      onepass_stage(smem_bf16 + i * 3 * kTile, kLd, kTile, qkv, D, N, d, b,
                    h, vec, r0, c0, dr, dc);
    }
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int next = i + kStages - 1;
    if (next < count) {
      b = (first + next) / heads;
      h = first + next - b * heads;
      onepass_stage(smem_bf16 + (next % kStages) * 3 * kTile, kLd, kTile, qkv,
                    D, N, d, b, h, vec, r0, c0, dr, dc);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // item i's group has landed
    __syncthreads();
    bf16* st = smem_bf16 + (i % kStages) * 3 * kTile;
    b = (first + i) / heads;
    h = first + i - b * heads;
    onepass_tile<kKC, kD16, kBf16Sm>(st + warp * 16 * kLd, st + kTile,
                                     st + 2 * kTile, N, d, scale, warp * 16,
                                     out + static_cast<int64_t>(b) * N * D +
                                         static_cast<int64_t>(h) * d,
                                     D, vec);
    __syncthreads();  // the stage is free for item i + kStages
  }
}

// ---------------------------------------------------------------------------
// K1, K5a, K5b tile (bf16, N <= 64, d % 16 == 0, d <= 128): TMA and wgmma;
// see the note at the top
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 384;  // a producer and two consumer warpgroups
constexpr int kBox = 64 * 128;     // a TMA box's region: 64 rows of 128 bytes
constexpr int kTileMaxN = 64;      // keys and query rows: one m64 tile
// ring stages: the fastest of depths 3 to 8 at the slice shape on an H100
// (deeper rings were slower); 4 also fit beside the output tiles at d = 128
constexpr int kTileStages = 4;

// bytes of a ring stage: Q, K and V of one item, each d64 boxes of 64
// head-dim columns
__host__ __device__ constexpr int tile_stage_bytes(int d64) {
  return 3 * d64 * kBox;
}

// dynamic shared memory of a tile block: the slack that aligns the ring to
// the swizzle period, the ring, the two consumers' output tiles and the
// ring's full and empty and the consumers' two turn mbarriers
__host__ __device__ inline size_t tile_smem_bytes(int d) {
  const int d64 = (d + 63) / 64;
  return kSwizzleAlign +
         static_cast<size_t>(kTileStages) * tile_stage_bytes(d64) +
         2 * static_cast<size_t>(d64) * kBox +
         static_cast<size_t>(2 * kTileStages + 2) * sizeof(uint64_t);
}

// kDK = d / 16: the k-steps of S = Q.K^T. Block x takes items x, x + grid,
// ...; the producer streams them through the ring in that order and the
// consumers take alternate ones (consumer c the block's items c, c + 2,
// ...). A consumer waits for an item's stage only after the other has
// seen the previous item's stage land (turn mbarriers), so every wait by
// parity on the ring is within one phase of the barrier.
template <int kDK, bool kBf16Sm>
__global__ void __launch_bounds__(kTileThreads, 1)
    attention_tile_kernel(const __grid_constant__ CUtensorMap qkv_map,
                          bf16* __restrict__ out, int items, int N,
                          int heads, float scale) {
  constexpr int kD64 = (kDK + 3) / 4;  // 64-column boxes of an operand
  constexpr int kDN = 64 * kD64;       // P.V's n: the boxes' columns
  constexpr int kStage = tile_stage_bytes(kD64);
  constexpr int kChunks = 2 * kDK;     // 16-byte pieces of an output row
  constexpr int d = 16 * kDK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + kSwizzleAlign - 1) & ~(kSwizzleAlign - 1);
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t outs = ring + kTileStages * kStage;  // consumers' tiles
  const uint32_t full = outs + 2 * kD64 * kBox;
  const uint32_t empty = full + 8 * kTileStages;  // full[s], then empty[s]
  const uint32_t turn = empty + 8 * kTileStages;  // turn[consumer]
  const int64_t D = static_cast<int64_t>(heads) * d;
  const int wg = threadIdx.x >> 7;

  // zero the pad rows N..63 of every box of every stage, once: the boxes
  // are N rows, so TMA never writes there, and a pad key's V row is then
  // 0 (its probability is 0, and 0 * 0 adds nothing)
  for (int z = 0; z < kTileStages * 3 * kD64; ++z) {
    uint4* pad = reinterpret_cast<uint4*>(ring_ptr + z * kBox + N * 128);
    for (int i = threadIdx.x; i < (kTileMaxN - N) * 8; i += blockDim.x)
      pad[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();  // the zeros are visible to wgmma's operand reads
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTileStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 4);  // each warp of the consuming warpgroup
    }
    mbar_init(turn, 1);      // consumer 1 has seen its item's stage land
    mbar_init(turn + 8, 1);  // consumer 0 has
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const uint32_t bytes = 3 * kD64 * N * 128;
      int s = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int b = it / heads;
        const int h = it - b * heads;
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t st = ring + s * kStage;
        mbar_expect_tx(full + 8 * s, bytes);
#pragma unroll
        for (int m = 0; m < 3; ++m)  // Q, K, V
#pragma unroll
          for (int x = 0; x < kD64; ++x)
            tma_load(st + (m * kD64 + x) * kBox, &qkv_map, full + 8 * s,
                     static_cast<int>(m * D) + h * d + 64 * x, b * N);
        if (++s == kTileStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;  // this consumer
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t = lane & 3;
  // accumulator layout: this thread holds rows rw and rw + 8 of the item,
  // columns 8 j + 2 t and + 1 of each 8-column group j
  const int rw = (tid >> 5) * 16 + (lane >> 2);
  uint8_t* tile = ring_ptr + (outs - ring) + c * kD64 * kBox;

  for (int j = c, turns = 0; blockIdx.x + j * gridDim.x < items;
       j += 2, ++turns) {
    const int it = blockIdx.x + j * gridDim.x;
    const int b = it / heads;
    const int h = it - b * heads;
    const int s = j % kTileStages;
    if (j > 0) mbar_wait(turn + 8 * c, (c == 0 ? turns - 1 : turns) & 1);
    mbar_wait(full + 8 * s, (j / kTileStages) & 1);
    if (tid == 0) mbar_arrive(turn + 8 * (1 - c));
    const uint32_t q_st = ring + s * kStage;
    const uint32_t k_st = q_st + kD64 * kBox;
    const uint32_t v_st = k_st + kD64 * kBox;

    // S = Q.K^T over 64 (padded) keys: k-step k is 32 bytes into the
    // swizzle row of box k / 4; 8-row groups 1024 bytes apart
    float l[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) l[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kDK; ++k) {
      const uint32_t off = (k / 4) * kBox + 32 * (k % 4);
      wgmma_ss<64, 0>(l, sw128_desc(q_st + off, 16, 1024),
                      sw128_desc(k_st + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(l);

    // softmax over the whole row (fp32, or the bf16 chain): scale after the
    // dot, keys >= N -inf
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      l[i] = key < N ? sm_logit<kBf16Sm>(l[i], scale) : -INFINITY;
      m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], l[i]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      l[i] = sm_exp<kBf16Sm>(l[i], m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += l[i];
    }
    float rs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      sum[hh] = sm_round<kBf16Sm>(sum[hh]);
      rs[hh] = __frcp_rn(sum[hh]);
    }
    // p = e / s (a reciprocal and one FMA correction: the quotient),
    // rounded to bf16: the accumulator layout of key groups 2 kc and
    // 2 kc + 1 is the register-A layout of P.V's k-step kc
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ev = l[8 * kc + e];
        const float r = rs[(e >> 1) & 1], sv = sum[(e >> 1) & 1];
        const float q = ev * r;
        p[e] = fmaf(fmaf(-q, sv, ev), r, q);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kc][e] = pack_f32(p[2 * e], p[2 * e + 1]);
    }

    // O = P.V: V is MN-major (head-dim columns contiguous), k-steps of 16
    // keys 2048 bytes apart, 8-key groups 1024 apart, boxes kBox apart
    float o[kDN / 2];
#pragma unroll
    for (int i = 0; i < kDN / 2; ++i) o[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<kDN, 1>(o, pa[kc], sw128_desc(v_st + 2048 * kc, kBox, 1024),
                       1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with it

    // O rounded to bf16 into this consumer's tile (128-byte rows, 16-byte
    // chunk q of row r at chunk q ^ (r % 8): conflict-free both ways), then
    // 16-byte stores of rows < N
    named_sync(1 + c, 128);  // the previous item's chunks are all read
#pragma unroll
    for (int jn = 0; jn < kChunks; ++jn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rw + 8 * hh;
        *reinterpret_cast<uint32_t*>(
            tile + (jn >> 3) * kBox + r * 128 + (((jn & 7) ^ (r & 7)) << 4) +
            4 * t) = pack_f32(o[4 * jn + 2 * hh], o[4 * jn + 2 * hh + 1]);
      }
    named_sync(1 + c, 128);
    bf16* ob = out + static_cast<int64_t>(b) * N * D +
               static_cast<int64_t>(h) * d;
    for (int i = tid; i < N * kChunks; i += 128) {
      const int r = i / kChunks;
      const int q = i - r * kChunks;
      *reinterpret_cast<uint4*>(ob + r * D + 8 * q) =
          *reinterpret_cast<const uint4*>(tile + (q >> 3) * kBox + r * 128 +
                                          (((q & 7) ^ (r & 7)) << 4));
    }
  }
}

// ---------------------------------------------------------------------------
// K2, both dtypes: one warp per (image, head), every warp computing
// ---------------------------------------------------------------------------

constexpr int kK2Warps = 8;  // most warps a K2 block takes
constexpr int kK2Ahead = 8;  // keys whose V loads are issued together

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8],
                                       const bf16*) {  // 8 bf16 -> fp32
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4],
                                       const float*) {  // 4 fp32
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// Load this lane's columns 2*lane + 64*t, + 1 (t = 0, 1) of a V row as
// fp32 (zero past d). kVec: the pair is one 4-byte (bf16) or 8-byte (fp32)
// load.
template <typename T, bool kVec>
__device__ __forceinline__ void k2_load_pair(float (&v)[2][2],
                                             const T* __restrict__ row,
                                             int lane, int d) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = 2 * lane + 64 * t;
    if constexpr (kVec) {
      if (c < d) {
        if constexpr (sizeof(T) == 2) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + c));
          v[t][0] = x.x;
          v[t][1] = x.y;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(row + c);
          v[t][0] = x.x;
          v[t][1] = x.y;
        }
      } else {
        v[t][0] = v[t][1] = 0.f;
      }
    } else {
      v[t][0] = c < d ? to_f32(row[c]) : 0.f;
      v[t][1] = c + 1 < d ? to_f32(row[c + 1]) : 0.f;
    }
  }
}

// K2. Warp w of block x takes item x * warps + w (item = b*heads + h), in
// the row code's order (the note at the top): lane j the logits of keys j,
// j + 32, ..., each an FMA chain over the head dim against q0 in shared
// memory; the row code's sum tree; p = e / s rounded to the io dtype; lane
// l output columns 2l, 2l+1 (and +64), FMA chains over the keys, the V
// loads of kK2Ahead keys issued together.
template <typename T, bool kVec, bool kBf16Sm>
__global__ void __launch_bounds__(kK2Warps* kWarp)
    k2_attention_kernel(const T* __restrict__ q0, const T* __restrict__ kv,
                        T* __restrict__ out, int N, int heads, int d,
                        float scale, int items) {
  constexpr int kW = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int item = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (item >= items) return;  // nothing below synchronizes the block
  const int d4 = round_up(d, 4);
  float* qs = smem + static_cast<size_t>(warp) * (d4 + round_up(N, 4));
  float* ps = qs + d4;  // logits, then probabilities
  const int64_t b = item / heads;
  const int h = item - static_cast<int>(b) * heads;
  const int64_t D = static_cast<int64_t>(heads) * d;
  const int64_t rs = 2 * D;  // kv row stride
  const T* kp = kv + b * N * rs + static_cast<int64_t>(h) * d;
  const T* vp = kp + D;
  const T* qp = q0 + b * D + static_cast<int64_t>(h) * d;

  for (int c = lane; c < d4; c += kWarp)
    qs[c] = c < d ? to_f32(qp[c]) : 0.f;
  __syncwarp();

  float m = -INFINITY;
  for (int j = lane; j < N; j += kWarp) {
    const T* kr = kp + j * rs;
    float acc = 0.f;
    if constexpr (kVec) {
#pragma unroll 4
      for (int c = 0; c < d; c += kW) {
        float k[kW];
        unpack(__ldg(reinterpret_cast<const uint4*>(kr + c)), k, kr);
#pragma unroll
        for (int e = 0; e < kW; ++e) acc = fmaf(qs[c + e], k[e], acc);
      }
    } else {
      for (int c = 0; c < d; ++c) acc = fmaf(qs[c], to_f32(kr[c]), acc);
    }
    const float l = sm_logit<kBf16Sm>(acc, scale);
    ps[j] = l;
    m = fmaxf(m, l);
  }
  m = warp_max(m);
  __syncwarp();
  float s = 0.f;
  for (int j = lane; j < N; j += kWarp) {
    const float e = sm_exp<kBf16Sm>(ps[j], m);
    ps[j] = e;
    s += e;
  }
  s = sm_round<kBf16Sm>(warp_sum(s));
  for (int j = lane; j < N; j += kWarp)
    ps[j] = to_f32(from_f32<T>(sm_round<kBf16Sm>(ps[j] / s)));
  __syncwarp();

  float o[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int j0 = 0; j0 < N; j0 += kK2Ahead) {
    float v[kK2Ahead][2][2];
#pragma unroll
    for (int u = 0; u < kK2Ahead; ++u)
      k2_load_pair<T, kVec>(
          v[u], vp + static_cast<int64_t>(min(j0 + u, N - 1)) * rs, lane, d);
#pragma unroll
    for (int u = 0; u < kK2Ahead; ++u) {
      if (j0 + u < N) {
        const float p = ps[j0 + u];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          o[t][0] = fmaf(p, v[u][t][0], o[t][0]);
          o[t][1] = fmaf(p, v[u][t][1], o[t][1]);
        }
      }
    }
  }
  T* ob = out + b * D + static_cast<int64_t>(h) * d;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = 2 * lane + 64 * t;
    if (c < d) ob[c] = from_f32<T>(o[t][0]);
    if (c + 1 < d) ob[c + 1] = from_f32<T>(o[t][1]);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

size_t smem_bytes(int n_q, int N, int d, int n_warps) {
  return sizeof(float) * layout(n_q, N, d, n_warps).total;
}

size_t packed_smem_bytes(int dtype, int M, int d, int n_warps) {
  if (dtype == 1) return sizeof(bf16) * 2 * mma_layout(M, d).tile;
  return smem_bytes(M, M, d, n_warps);
}

size_t headbatched_smem_bytes(int dtype, int N, int d, int hp, int n_warps) {
  if (dtype == 1) return sizeof(bf16) * 2 * hp * mma_layout(N, d).tile;
  const Layout L = layout(N, N, d, n_warps);
  return sizeof(float) *
         (hp * L.p + static_cast<size_t>(n_warps) * kRows * L.n4);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // above 48 KB only by opting in
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// K1 (seg == 0) and K5a on the CUDA cores (seg = tokens per image).
template <typename T>
int launch(const void* q, int64_t q_batch, int64_t q_row, int n_q,
           const void* k, const void* v, int64_t kv_batch, int64_t kv_row,
           void* out, int64_t out_batch, int64_t out_row, int B, int N,
           int heads, int d, float scale, int n_warps, int seg, bool bf16_sm,
           cudaStream_t stream) {
  auto kernel = seg       ? packed_attention_fma_kernel<T>
                : bf16_sm ? attention_kernel<T, true>
                          : attention_kernel<T, false>;
  const size_t smem = smem_bytes(n_q, N, d, n_warps);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte staging loads: every row start is then 16-byte aligned too,
  // since d (hence every head offset and row stride) is a multiple of kVec
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v);
  kernel<<<dim3(B, heads), n_warps * kWarp, smem, stream>>>(
      static_cast<const T*>(q), q_batch, q_row, n_q,
      static_cast<const T*>(k), static_cast<const T*>(v), kv_batch, kv_row,
      static_cast<T*>(out), out_batch, out_row, N, d, scale, vec, seg);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, const void* q, int64_t q_batch, int64_t q_row,
             int n_q, const void* k, const void* v, int64_t kv_batch,
             int64_t kv_row, void* out, int64_t out_batch, int64_t out_row,
             int B, int N, int heads, int d, float scale, int n_warps,
             int seg, bool bf16_sm, int device, void* stream) {
  if (d < 1 || d > kMaxD || N < 1 || B < 1 || heads < 1 || n_warps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, q_batch, q_row, n_q, k, v, kv_batch, kv_row, out,
                         out_batch, out_row, B, N, heads, d, scale, n_warps,
                         seg, bf16_sm, s);
  if (dtype == 1)
    return launch<bf16>(q, q_batch, q_row, n_q, k, v, kv_batch, kv_row, out,
                        out_batch, out_row, B, N, heads, d, scale, n_warps,
                        seg, bf16_sm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

size_t k2_smem_bytes(int N, int d, int warps) {  // q0 and p, each warp
  return sizeof(float) * warps *
         static_cast<size_t>(round_up(d, 4) + round_up(N, 4));
}

template <typename T, bool kVec>
cudaError_t launch_k2(const void* q0, const void* kv, void* out, int B,
                      int N, int heads, int d, float scale, int warps,
                      bool bf16_sm, cudaStream_t stream) {
  auto kernel = bf16_sm ? k2_attention_kernel<T, kVec, true>
                        : k2_attention_kernel<T, kVec, false>;
  const size_t smem = k2_smem_bytes(N, d, warps);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int items = B * heads;
  kernel<<<(items + warps - 1) / warps, warps * kWarp, smem, stream>>>(
      static_cast<const T*>(q0), static_cast<const T*>(kv),
      static_cast<T*>(out), N, heads, d, scale, items);
  return cudaGetLastError();
}

size_t onepass_smem_bytes(int N, int d) {
  return sizeof(bf16) * static_cast<size_t>(kStages) * 3 * round_up(N, 16) *
         (onepass_d16(d) * 16 + kPad16);
}

template <int kKC, int kD16>
cudaError_t launch_onepass(const bf16* qkv, bf16* out, int B, int N,
                           int heads, int d, float scale, int per_block,
                           bool vec, bool bf16_sm, cudaStream_t stream) {
  auto kernel = bf16_sm ? k5_onepass_kernel<kKC, kD16, true>
                        : k5_onepass_kernel<kKC, kD16, false>;
  const size_t smem = onepass_smem_bytes(N, d);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int items = B * heads;
  kernel<<<(items + per_block - 1) / per_block, kKC * kWarp, smem, stream>>>(
      qkv, out, B, N, heads, d, scale, per_block, vec);
  return cudaGetLastError();
}

template <int kKC>
cudaError_t launch_onepass_d(const bf16* qkv, bf16* out, int B, int N,
                             int heads, int d, float scale, int per_block,
                             bool vec, bool bf16_sm, cudaStream_t s) {
  switch (onepass_d16(d)) {
    case 2:
      return launch_onepass<kKC, 2>(qkv, out, B, N, heads, d, scale,
                                    per_block, vec, bf16_sm, s);
    case 4:
      return launch_onepass<kKC, 4>(qkv, out, B, N, heads, d, scale,
                                    per_block, vec, bf16_sm, s);
    default:
      return launch_onepass<kKC, 8>(qkv, out, B, N, heads, d, scale,
                                    per_block, vec, bf16_sm, s);
  }
}

template <int kDK>
cudaError_t launch_tile(const CUtensorMap& map, bf16* out, int items, int N,
                        int heads, float scale, int blocks, size_t smem,
                        bool bf16_sm, cudaStream_t stream) {
  auto kernel = bf16_sm ? attention_tile_kernel<kDK, true>
                        : attention_tile_kernel<kDK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTileThreads, smem, stream>>>(map, out, items, N, heads,
                                                 scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one K1 block needs, for the wrapper's shape check.
size_t lossyless_attention_smem_bytes(int n_q, int N, int d, int n_warps) {
  return smem_bytes(n_q, N, d, n_warps);
}

// K1. qkv (B, N, 3*heads*d) contiguous -> out (B, N, heads*d).
// dtype: 0 = float32, 1 = bfloat16. softmax_bf16: SOFTMAX_DTYPE's bf16
// chain (kBf16Sm), else fp32.
int lossyless_fused_attention(const void* qkv, void* out, int B, int N,
                              int heads, int d, int dtype, float scale,
                              int n_warps, int softmax_bf16, int device,
                              void* stream) {
  const int64_t D = static_cast<int64_t>(heads) * d;
  const size_t es = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  return dispatch(dtype, base, N * 3 * D, 3 * D, N, base + D * es,
                  base + 2 * D * es, N * 3 * D, 3 * D, out, N * D, D, B, N,
                  heads, d, scale, n_warps, 0, softmax_bf16 != 0, device,
                  stream);
}

// Shared memory one K2 block of `warps` warps uses.
size_t lossyless_attention_k2_smem_bytes(int N, int d, int warps) {
  return k2_smem_bytes(N, d, warps);
}

// K2. q0 (B, 1, heads*d), kv (B, N, 2*heads*d) contiguous -> out
// (B, 1, heads*d), one warp per (image, head), `warps` warps a block. vec
// selects 16-byte loads (refused unless q0, kv and out are 16-byte aligned
// and d is a whole number of 16-byte chunks). softmax_bf16 as K1's.
int lossyless_fused_attention_cls(const void* q0, const void* kv, void* out,
                                  int B, int N, int heads, int d, int dtype,
                                  float scale, int warps, int vec,
                                  int softmax_bf16, int device,
                                  void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (B < 1 || N < 1 || heads < 1 || d < 1 || d > kMaxD ||
      (dtype != 0 && dtype != 1) || warps < 1 || warps > kK2Warps ||
      (vec && (!aligned16(q0) || !aligned16(kv) || !aligned16(out) ||
               (d * es) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const bool sm = softmax_bf16 != 0;
  if (dtype == 0)
    err = vec ? launch_k2<float, true>(q0, kv, out, B, N, heads, d, scale,
                                       warps, sm, s)
              : launch_k2<float, false>(q0, kv, out, B, N, heads, d, scale,
                                        warps, sm, s);
  else
    err = vec ? launch_k2<bf16, true>(q0, kv, out, B, N, heads, d, scale,
                                      warps, sm, s)
              : launch_k2<bf16, false>(q0, kv, out, B, N, heads, d, scale,
                                       warps, sm, s);
  return static_cast<int>(err);
}

// Shared memory of one K5a block: the group's M = pack*N tokens.
size_t lossyless_attention_packed_smem_bytes(int dtype, int M, int d,
                                             int n_warps) {
  return packed_smem_bytes(dtype, M, d, n_warps);
}

// K5a. qkv (B, N, 3*heads*d) contiguous -> out (B, N, heads*d); B % pack
// == 0, pack >= 2. bf16 on the tensor cores, fp32 on the CUDA cores.
int lossyless_fused_attention_packed(const void* qkv, void* out, int B,
                                     int N, int heads, int d, int pack,
                                     int dtype, float scale, int n_warps,
                                     int device, void* stream) {
  if (pack < 2 || B < 1 || B % pack || N < 1 || d < 1 || d > kMaxD ||
      heads < 1 || n_warps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t D = static_cast<int64_t>(heads) * d;
  const int M = pack * N;
  if (dtype == 0) {
    const char* base = static_cast<const char*>(qkv);
    return dispatch(0, base, M * 3 * D, 3 * D, M, base + D * 4,
                    base + 2 * D * 4, M * 3 * D, 3 * D, out, M * D, D,
                    B / pack, M, heads, d, scale, n_warps, N, false, device,
                    stream);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = packed_smem_bytes(1, M, d, n_warps);
  err = allow_smem(packed_attention_mma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 8 == 0 && aligned16(qkv);
  packed_attention_mma_kernel<<<dim3(B / pack, heads), n_warps * kWarp,
                                smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, pack, heads,
      d, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one K5b block staging `heads_per_pass` heads.
size_t lossyless_attention_headbatched_smem_bytes(int dtype, int N, int d,
                                                  int heads_per_pass,
                                                  int n_warps) {
  return headbatched_smem_bytes(dtype, N, d, heads_per_pass, n_warps);
}

// K5b. qkv (B, N, 3*heads*d) contiguous -> out (B, N, heads*d), one block
// per image staging `hp` (1..heads) heads a pass. bf16 on the tensor cores,
// fp32 on the CUDA cores.
int lossyless_fused_attention_headbatched(const void* qkv, void* out, int B,
                                          int N, int heads, int d, int dtype,
                                          float scale, int n_warps, int hp,
                                          int device, void* stream) {
  if (B < 1 || N < 1 || d < 1 || d > kMaxD || heads < 1 || n_warps < 1 ||
      hp < 1 || hp > heads || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = headbatched_smem_bytes(dtype, N, d, hp, n_warps);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = allow_smem(headbatched_attention_mma_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = d % 8 == 0 && aligned16(qkv);
    headbatched_attention_mma_kernel<<<B, n_warps * kWarp, smem, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, heads, d,
        scale, hp, vec);
  } else {
    err = allow_smem(headbatched_attention_fma_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = d % 4 == 0 && aligned16(qkv);
    headbatched_attention_fma_kernel<float><<<B, n_warps * kWarp, smem, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), N, heads, d,
        scale, hp, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one one-pass K5a/K5b block: kStages ring stages of
// one item's Q, K and V.
size_t lossyless_attention_k5_onepass_smem_bytes(int N, int d) {
  return onepass_smem_bytes(N, d);
}

// K1, K5a and K5b on the one-pass tile: qkv (B, N, 3*heads*d) bf16
// contiguous -> out (B, N, heads*d); N <= 64. Blocks of ceil(N/16) warps
// take runs of `per_block` (image, head) items in image-major order through
// a ring of kStages stages. vec selects cp.async 16-byte copies and 16-byte
// stores (refused unless qkv and out are 16-byte aligned and d % 8 == 0).
// softmax_bf16 as K1's (K5a and K5b pass 0).
int lossyless_fused_attention_k5_onepass(const void* qkv, void* out, int B,
                                         int N, int heads, int d,
                                         float scale, int per_block,
                                         int vec, int softmax_bf16,
                                         int device, void* stream) {
  if (B < 1 || N < 1 || N > kOnePassMaxN || d < 1 || d > kMaxD ||
      heads < 1 || per_block < 1 ||
      static_cast<int64_t>(B) * heads > INT32_MAX ||          // items
      static_cast<int64_t>(N) * 3 * heads * d > INT32_MAX ||  // an image
      (vec && (!aligned16(qkv) || !aligned16(out) || d % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto q = static_cast<const bf16*>(qkv);
  auto o = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((N + 15) / 16) {
    case 1:
      err = launch_onepass_d<1>(q, o, B, N, heads, d, scale, per_block,
                                vec, softmax_bf16 != 0, s);
      break;
    case 2:
      err = launch_onepass_d<2>(q, o, B, N, heads, d, scale, per_block,
                                vec, softmax_bf16 != 0, s);
      break;
    case 3:
      err = launch_onepass_d<3>(q, o, B, N, heads, d, scale, per_block,
                                vec, softmax_bf16 != 0, s);
      break;
    default:
      err = launch_onepass_d<4>(q, o, B, N, heads, d, scale, per_block,
                                vec, softmax_bf16 != 0, s);
      break;
  }
  return static_cast<int>(err);
}

// Shared memory of one tile block (K1, K5a, K5b) at head dim d.
size_t lossyless_attention_tile_smem_bytes(int d) {
  return tile_smem_bytes(d);
}

// K1, K5a and K5b on the tile: qkv (B, N, 3*heads*d) bf16 contiguous ->
// out (B, N, heads*d), both 16-byte aligned; N <= 64, d a multiple of 16
// up to 128. The plan's geometry (`blocks` persistent blocks, `smem`
// bytes) must be this file's. softmax_bf16 as K1's (K5a and K5b pass 0).
int lossyless_fused_attention_tile(const void* qkv, void* out, int B, int N,
                                   int heads, int d, float scale, int blocks,
                                   size_t smem, int softmax_bf16, int device,
                                   void* stream) {
  const int64_t items = static_cast<int64_t>(B) * heads;
  if (B < 1 || N < 1 || N > kTileMaxN || heads < 1 || d < 16 || d % 16 ||
      d > kMaxD || items > INT32_MAX ||
      static_cast<int64_t>(B) * N > INT32_MAX ||
      static_cast<int64_t>(3) * heads * d > INT32_MAX || blocks < 1 ||
      smem != tile_smem_bytes(d) || smem > kMaxSmem ||
      !aligned16(qkv) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  if (!bf16_map(&map, qkv, static_cast<int64_t>(3) * heads * d,
                static_cast<int64_t>(B) * N, N))
    return static_cast<int>(cudaErrorInvalidValue);
  auto o = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(items);
  const bool sm = softmax_bf16 != 0;
  switch (d / 16) {
    case 1:
      err = launch_tile<1>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    case 2:
      err = launch_tile<2>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    case 3:
      err = launch_tile<3>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    case 4:
      err = launch_tile<4>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    case 5:
      err = launch_tile<5>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    case 6:
      err = launch_tile<6>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    case 7:
      err = launch_tile<7>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
    default:
      err = launch_tile<8>(map, o, n, N, heads, scale, blocks, smem, sm,
                           st);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
