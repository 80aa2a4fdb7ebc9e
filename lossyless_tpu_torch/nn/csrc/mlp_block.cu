// Fused MLP half-block of a pre-LN transformer, hand-written for Hopper.
//
// K4  lossyless_fused_mlp_block_tile (the wgmma design) and
//     lossyless_fused_mlp_block (the mma.sync design) replace the Pallas
//     kernel lossyless_tpu/nn/flash_attn.py::fused_mlp_block (_mlp_kernel):
//     out = x + proj(QuickGELU(fc(LayerNorm(x)))) over (M, D) rows,
//     fc_w (D, H), pr_w (H, D), bf16 in and out.
//
// Rounding points (the TPU kernel's, _mlp_kernel):
//   1. LayerNorm statistics in fp32, var = mean((x - mean)^2), eps inside
//      rsqrt; y = (x - mean) * rsqrt(var + eps) * scale + bias in fp32;
//   2. y rounded to bf16;
//   3. hidden = y . fc_w accumulated in fp32, rounded to bf16, + fc_b (bf16);
//   4. QuickGELU h * (1 / (1 + exp(-1.702 h))), every op rounded to bf16
//      (the constant too);
//   5. proj = h . pr_w accumulated in fp32, rounded to bf16, + pr_b, + x.
//
// Two designs; `k4_plan` (nn/flash_attn.py) picks one from the shape and
// the C side checks the plan's shared memory against its own count.
//
// The wgmma design (D and H multiples of 64; the ViT-B/32 shape). The TPU
// kernel keeps the (rows, H) hidden on chip, which forces small row tiles
// on Hopper: a 128-row tile's (128 x D) fp32 output accumulator alone is
// 384 KB at D = 768, more than an SM's register file. The TPU kernel
// rounds the hidden to bf16 before its bias add, so passing it through
// device memory in bf16 adds no rounding point; at M = 6,400, H = 3,072 it
// is 39 MB, which mostly stays in the 50 MB L2. So a call runs three
// kernels:
//   1. mlp_block_kernel_ln: one warp a row, 16-byte loads; writes y (M, D)
//      bf16 (rounding points 1-2);
//   2. mlp_block_kernel_tile<BN, true>: hidden = y . fc_w, epilogue 3-4,
//      hidden (M, H) bf16 out;
//   3. mlp_block_kernel_tile<BN, false>: hidden . pr_w, epilogue 5 (reads
//      x and pr_b), out (M, D).
// The tile kernel is persistent (one block an SM) over 128 x BN output
// tiles (BN = 128 where it divides N). A producer warpgroup's first
// thread streams every k-step of 64 of the block's tiles through one ring
// of shared memory with TMA (cp.async.bulk.tensor, 128-byte swizzle, zero
// fill past the ragged last row tile), completion on mbarriers. Two
// consumer warpgroups take alternate tiles (ping-pong) and turns at the
// tensor cores: each runs wgmma.mma_async m64nBNk16 (bf16 in, fp32 in
// registers) for both 64-row halves of its tile straight from the ring,
// A (y or the hidden) K-major and B (the weights, row-major (K, N) as
// stored: no copy is made) MN-major, one k-step's group in flight while
// the next is issued, then runs its epilogue (through its own tile in
// shared memory, 16-byte stores) while the other consumer's products run
// and the producer fetches ahead. setmaxnreg moves registers from the
// producer (40) to the consumers (232) for their 128-float accumulators.
// What holds it (PERF.md): the products' mainloops reach ~60% of the
// tensor cores' peak (both operands read from shared memory, which TMA
// also fills); fc's QuickGELU epilogue is about as long as a tile's
// products, so ping-pong hides only part of it; proj's 300 tiles leave the
// last of its 2.3 tiles a block alone on 36 SMs.
//
// The mma.sync design (the first; any D <= 768 that is a multiple of 8,
// H a multiple of 32). The TPU kernel keeps both weight matrices resident
// in VMEM (~9.4 MB); an SM has 227 KB of shared memory. So a block (CTA)
// owns kRowsPerBlock = 32 token rows and streams the weights past them:
//   * the block's LayerNorm is computed once into shared memory (bf16 y);
//   * the hidden axis H is walked in chunks of kChunk = 32. For each chunk
//     the block stages fc_w[:, chunk] and pr_w[chunk, :] in shared memory
//     with cp.async, computes the (32 x 32) hidden chunk with tensor-core
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate; one 16x8 tile per warp),
//     applies bias and QuickGELU into shared memory, and accumulates
//     hidden_chunk . pr_w[chunk, :] into the (32 x D) fp32 accumulator,
//     which lives in registers: each of the 8 warps owns D/64 column tiles
//     of 8 (12 at D = 768: 96 fp32 registers a thread);
//   * the loads overlap the products: fc_w[:, next] is fetched while the
//     block runs the second product of this chunk, pr_w[next, :] while it
//     runs the first product of the next; blocks start their walk over the
//     chunks at different chunks (the fp32 sum over the hidden axis then
//     runs in a rotated order);
//   * each warp loads the operand fragments of several products before
//     issuing them, so ldmatrix latency overlaps the tensor-core work;
//   * the (M, H) hidden activation never reaches device memory.
// Operand fragments come from shared memory through ldmatrix (.trans for the
// row-major weight tiles); row pitches are padded by 16 bytes so the eight
// row addresses of each ldmatrix hit distinct banks. Each of its blocks
// re-reads all 9.4 MB of weights from L2 (1.9 GB a call at the slice
// shape), about 32 flop a byte: L2 bandwidth and barriers bound it.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the slice
// shape M = 128 x 50 = 6,400, D = 768, H = 3,072: 4 M D H = 60.4 GFLOP,
// 0.061 ms; it moves ~29 MB (x in, out, both weights once), 0.009 ms. The
// tensor cores bound it, whatever the design.
//
// Interface: plain C, loaded with ctypes. The launcher runs on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;              // two m16 tiles
constexpr int kChunk = 32;                     // hidden columns per step
constexpr int kMaxTilesPerWarp = 12;           // D <= 8 * 8 * 12 = 768
constexpr int kMaxD = kWarps * 8 * kMaxTilesPerWarp;
constexpr int kPad = 8;                        // bf16 elements (16 bytes)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float rbf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment (16 x 16, row-major at `p`, pitch in elements) of
// mma.m16n8k16: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
// (rows 0-7, k 8-15), (rows 8-15, k 8-15).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* p,
                                       int pitch) {
  const int lane = threadIdx.x & 31;
  const int i = lane >> 3;
  const bf16* row = p + ((lane & 7) + (i & 1) * 8) * pitch + (i >> 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(row)));
}

// B fragment (16 x 8) from a row-major [k][n] tile at `p`: the two 8 x 8
// halves (k 0-7, k 8-15) loaded transposed.
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* p,
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

struct Layout {
  int d16, ld_y, ld_w1, ld_w2, ld_h;
  size_t w1, w2, h, total;  // offsets and size in bf16 elements
};

__host__ __device__ inline Layout layout(int D) {
  Layout L;
  L.d16 = (D + 15) / 16 * 16;  // the first product's depth, zero-padded
  L.ld_y = L.d16 + kPad;
  L.ld_w1 = kChunk + kPad;
  L.ld_w2 = D + kPad;
  L.ld_h = kChunk + kPad;
  L.w1 = static_cast<size_t>(kRowsPerBlock) * L.ld_y;
  L.w2 = L.w1 + static_cast<size_t>(L.d16) * L.ld_w1;
  L.h = L.w2 + static_cast<size_t>(kChunk) * L.ld_w2;
  L.total = L.h + static_cast<size_t>(kRowsPerBlock) * L.ld_h;
  return L;
}

__device__ __forceinline__ void stage_w1(bf16* w1s, int ld, const bf16* fc_w,
                                         int D, int H, int c0) {
  // fc_w[0:D, c0:c0+kChunk]: D rows of 4 x 16 bytes
  constexpr int kPieces = kChunk / 8;
  for (int i = threadIdx.x; i < D * kPieces; i += kThreads) {
    const int d = i / kPieces;
    const int p = (i - d * kPieces) * 8;
    cp_async16(w1s + d * ld + p, fc_w + static_cast<int64_t>(d) * H + c0 + p);
  }
}

__device__ __forceinline__ void stage_w2(bf16* w2s, int ld, const bf16* pr_w,
                                         int D, int c0) {
  // pr_w[c0:c0+kChunk, 0:D]: kChunk rows of D / 8 x 16 bytes
  const int pieces = D / 8;
  for (int i = threadIdx.x; i < kChunk * pieces; i += kThreads) {
    const int j = i / pieces;
    const int p = (i - j * pieces) * 8;
    cp_async16(w2s + j * ld + p, pr_w + static_cast<int64_t>(c0 + j) * D + p);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mlp_block_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias,
                     const bf16* __restrict__ fc_w,
                     const bf16* __restrict__ fc_b,
                     const bf16* __restrict__ pr_w,
                     const bf16* __restrict__ pr_b, bf16* __restrict__ out,
                     int M, int D, int H, float eps) {
  extern __shared__ __align__(16) bf16 smem[];
  const Layout L = layout(D);
  bf16* ys = smem;
  bf16* w1s = smem + L.w1;
  bf16* w2s = smem + L.w2;
  bf16* hs = smem + L.h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;

  // blocks start their walk over the hidden chunks at different chunks, so
  // the SMs do not all ask L2 for the same weight lines at once
  const int n_chunks = H / kChunk;
  const int first = blockIdx.x % n_chunks;
  // the weights of the first chunk arrive while the LayerNorm runs
  stage_w1(w1s, L.ld_w1, fc_w, D, H, first * kChunk);
  cp_async_commit();
  stage_w2(w2s, L.ld_w2, pr_w, D, first * kChunk);
  cp_async_commit();
  // rows D..d16 of the fc tile are the zero padding of the first product
  for (int i = threadIdx.x; i < (L.d16 - D) * L.ld_w1; i += kThreads)
    w1s[D * L.ld_w1 + i] = __float2bfloat16_rn(0.f);

  // 1-2. LayerNorm of the block's rows into ys (bf16); warp w owns 4 rows
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    bf16* yr = ys + r * L.ld_y;
    const int64_t m = m0 + r;
    if (m >= M) {
      for (int d = lane; d < L.d16; d += 32) yr[d] = __float2bfloat16_rn(0.f);
      continue;
    }
    const bf16* xr = x + m * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += __bfloat162float(xr[d]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float e = __bfloat162float(xr[d]) - mean;
      v = fmaf(e, e, v);
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float rstd = rsqrtf(v / D + eps);
    for (int d = lane; d < L.d16; d += 32) {
      float y = 0.f;
      if (d < D)
        y = (__bfloat162float(xr[d]) - mean) * rstd * ln_scale[d] +
            ln_bias[d];
      yr[d] = __float2bfloat16_rn(y);
    }
  }

  const int n_tiles = D / 8;  // output column tiles; warp w owns w, w+8, ...
  float acc[2][kMaxTilesPerWarp][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < kMaxTilesPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  const bf16 neg_k = __float2bfloat16_rn(-1.702f);
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = (first + c) % n_chunks * kChunk;
    const int next = (first + c + 1) % n_chunks * kChunk;
    cp_async_wait<1>();  // fc_w chunk c has landed (pr_w chunk c may not)
    __syncthreads();

    // 3-4. hidden tile (mt, nt) of this warp: 16 rows x 8 hidden columns
    {
      const int mt = warp >> 2, nt = warp & 3;
      // four independent accumulators over k, so the products do not wait
      // on one register set; the fragments of four k-steps are loaded
      // before their products, so the loads' latencies overlap
      float hh[4][4] = {};
      for (int k0 = 0; k0 < L.d16; k0 += 64) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + 16 * u;
          if (k < L.d16) {
            load_a(a[u], ys + mt * 16 * L.ld_y + k, L.ld_y);
            load_b(b[u], w1s + k * L.ld_w1 + nt * 8, L.ld_w1);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k0 + 16 * u < L.d16) mma(hh[u], a[u], b[u]);
      }
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + (e >= 2 ? 8 : 0);
        const int cc = col + (e & 1);
        const float h = (hh[0][e] + hh[1][e]) + (hh[2][e] + hh[3][e]);
        float v = rbf(rbf(h) + __bfloat162float(fc_b[c0 + cc]));
        const float z = rbf(__bfloat162float(neg_k) * v);
        const float den = rbf(1.f + rbf(expf(z)));
        v = rbf(v * rbf(1.f / den));
        hs[row * L.ld_h + cc] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();  // hs is complete; w1s is free
    if (c + 1 < n_chunks) {
      stage_w1(w1s, L.ld_w1, fc_w, D, H, next);
      cp_async_commit();
      cp_async_wait<1>();  // pr_w chunk c has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 5a. acc += hidden_chunk (32 x kChunk) . pr_w[chunk, :] (kChunk x D)
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t a0[4], a1[4], b[kMaxTilesPerWarp][2];
      load_a(a0, hs + k0, L.ld_h);
      load_a(a1, hs + 16 * L.ld_h + k0, L.ld_h);
#pragma unroll
      for (int i = 0; i < kMaxTilesPerWarp; ++i)
        if (i * kWarps + warp < n_tiles)
          load_b(b[i], w2s + k0 * L.ld_w2 + (i * kWarps + warp) * 8,
                 L.ld_w2);
#pragma unroll
      for (int i = 0; i < kMaxTilesPerWarp; ++i) {
        if (i * kWarps + warp < n_tiles) {
          mma(acc[0][i], a0, b[i]);
          mma(acc[1][i], a1, b[i]);
        }
      }
    }
    __syncthreads();  // w2s and hs are free
    if (c + 1 < n_chunks) {
      stage_w2(w2s, L.ld_w2, pr_w, D, next);
      cp_async_commit();
    }
  }

  // 5b. out = x + (bf16(acc) + pr_b), each add rounded to bf16
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < kMaxTilesPerWarp; ++i) {
      const int nt = i * kWarps + warp;
      if (nt >= n_tiles) continue;
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t m = m0 + mt * 16 + g + half * 8;
        if (m >= M) continue;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + m * D + col);
        const float o0 = rbf(rbf(acc[mt][i][2 * half]) +
                             __bfloat162float(pr_b[col]));
        const float o1 = rbf(rbf(acc[mt][i][2 * half + 1]) +
                             __bfloat162float(pr_b[col + 1]));
        *reinterpret_cast<__nv_bfloat162*>(out + m * D + col) =
            __floats2bfloat162_rn(__low2float(xv) + o0,
                                  __high2float(xv) + o1);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// The wgmma design
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;        // output rows a tile: two m64 halves
constexpr int kTileK = 64;         // a k-step: one 128-byte swizzle row
constexpr int kTileThreads = 384;  // a producer and two consumer warpgroups
constexpr int kABytes = kTileM * kTileK * 2;   // A tile of a stage
constexpr int kBoxBytes = 64 * kTileK * 2;     // one 64-column B box
constexpr int kLnWarps = 8;                    // LayerNorm pass: a warp a row

__host__ __device__ constexpr int stage_bytes(int bn) {
  return kABytes + bn / 64 * kBoxBytes;
}

// bytes of one consumer's epilogue tile: 128 rows of bn bf16, padded by
// 16 bytes so the rows start in different banks
__host__ __device__ constexpr int out_tile_bytes(int bn) {
  return kTileM * (bn + 8) * 2;
}

// dynamic shared memory of a tile block: the ring, the two consumers'
// epilogue tiles, the ring's full and empty mbarriers and the consumers'
// two turn mbarriers, and the slack that aligns the ring to the swizzle
// period
__host__ __device__ inline size_t tile_smem_bytes(int bn, int stages) {
  return kSwizzleAlign + static_cast<size_t>(stages) * stage_bytes(bn) +
         2 * out_tile_bytes(bn) +
         static_cast<size_t>(stages + 1) * 2 * sizeof(uint64_t);
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b) {
  wgmma_ss<BN, 1>(d, a, b, 1);  // B MN-major
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// QuickGELU v * (1 / (1 + exp(-1.702 v))) of two bf16 values, every
// operation rounded to bf16 (the constant too), as the plain version
// computes it. The two products are bf16x2 multiplies: the product of two
// bf16 values is exact in fp32, so rounding it once is the fp32 product
// rounded. 1 / den is rcp.approx rounded to bf16, which is the quotient
// correctly rounded: den is a bf16 value >= 1 (8 significant bits), so
// 1 / den lies at least 2^-17 (relative) from any bf16 rounding midpoint
// (9 significant bits; their product would be a power of two), far more
// than rcp.approx's error. Phase 3b of chip_smoke.py holds this function
// to the plain version at all 65,536 bf16 inputs.
__device__ __forceinline__ __nv_bfloat162 quick_gelu2(__nv_bfloat162 v) {
  const float2 z =
      __bfloat1622float2(__hmul2(__float2bfloat162_rn(-1.702f), v));
  const float2 e = __bfloat1622float2(__floats2bfloat162_rn(expf(z.x),
                                                            expf(z.y)));
  const float2 den =
      __bfloat1622float2(__floats2bfloat162_rn(1.f + e.x, 1.f + e.y));
  return __hmul2(v, __floats2bfloat162_rn(rcp_approx(den.x),
                                          rcp_approx(den.y)));
}

// 1-2. y = bf16(LayerNorm(x)), one warp a row, 8 bf16 (16 bytes) a load
__global__ void __launch_bounds__(kLnWarps * 32)
    mlp_block_kernel_ln(const bf16* __restrict__ x,
                        const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias,
                        bf16* __restrict__ y, int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t m =
      static_cast<int64_t>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const bf16* xr = x + m * D;
  bf16* yr = y + m * D;
  float s = 0.f;
  for (int d = 8 * lane; d < D; d += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      s += f.x + f.y;
    }
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / D;
  float var = 0.f;
  for (int d = 8 * lane; d < D; d += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      var = fmaf(f.x - mean, f.x - mean, var);
      var = fmaf(f.y - mean, f.y - mean, var);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    var += __shfl_xor_sync(0xffffffffu, var, o);
  const float rstd = rsqrtf(var / D + eps);
  for (int d = 8 * lane; d < D; d += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float4 sc0 = *reinterpret_cast<const float4*>(ln_scale + d);
    const float4 sc1 = *reinterpret_cast<const float4*>(ln_scale + d + 4);
    const float4 bi0 = *reinterpret_cast<const float4*>(ln_bias + d);
    const float4 bi1 = *reinterpret_cast<const float4*>(ln_bias + d + 4);
    const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w,
                         sc1.x, sc1.y, sc1.z, sc1.w};
    const float bi[8] = {bi0.x, bi0.y, bi0.z, bi0.w,
                         bi1.x, bi1.y, bi1.z, bi1.w};
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[i] = __floats2bfloat162_rn(
          (f.x - mean) * rstd * sc[2 * i] + bi[2 * i],
          (f.y - mean) * rstd * sc[2 * i + 1] + bi[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(yr + d) = out;
  }
}

// One (M, K) . (K, N) product in 128 x BN output tiles, persistent: block
// b takes tiles b, b + gridDim.x, ... (tile t: rows 128 (t / tiles_n),
// columns BN (t % tiles_n)). a_map: A (M rows of K), boxes of 64 x 128;
// b_map: B (K rows of N), boxes of 64 x 64, BN / 64 of them a k-step.
// Warpgroup 0's first thread streams the k-steps of all the block's tiles
// in order through one ring; warpgroups 1 and 2 take alternate tiles
// (ping-pong), each computing both 64-row halves of its tile, and take
// turns at the products (turn mbarriers): a consumer starts a tile's
// products once the other has finished the previous tile's, so its
// epilogue runs under the other's products, and the ring's waits by
// parity never see a phase more than one ahead. The producer fetches the
// next tile's first k-steps under the epilogues.
// kFc: epilogue 3-4 (+ bias, QuickGELU) into the hidden; else epilogue 5
// (+ bias, + x) into the output. N % BN == 0, K % 64 == 0.
template <int BN, bool kFc>
__global__ void __launch_bounds__(kTileThreads, 1)
    mlp_block_kernel_tile(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const bf16* __restrict__ bias,
                          const bf16* __restrict__ x, bf16* __restrict__ out,
                          int M, int N, int K, int stages) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t ring =
      (smem_addr(smem_raw) + kSwizzleAlign - 1) & ~(kSwizzleAlign - 1);
  const uint32_t bytes = stage_bytes(BN);
  const uint32_t outs = ring + stages * bytes;  // the consumers' tiles
  const uint32_t full = outs + 2 * out_tile_bytes(BN);
  const uint32_t empty = full + 8 * stages;     // full[s], then empty[s]
  const uint32_t turn = empty + 8 * stages;     // turn[consumer]
  const int steps = K / kTileK;
  const int tiles_n = N / BN;
  const int tiles = (M + kTileM - 1) / kTileM * tiles_n;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 1);  // the consuming warpgroup's release
    }
    mbar_init(turn, 1);      // consumer 1 has finished a tile's products
    mbar_init(turn + 8, 1);  // consumer 0 has
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kTileM;
        const int n0 = t % tiles_n * BN;
        for (int kb = 0; kb < steps; ++kb) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t a = ring + s * bytes;
          mbar_expect_tx(full + 8 * s, bytes);
          tma_load(a, &a_map, full + 8 * s, kb * kTileK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(a + kABytes + j * kBoxBytes, &b_map, full + 8 * s,
                     n0 + 64 * j, kb * kTileK);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;                  // this consumer
  const int tid = threadIdx.x & 127;
  bf16* tile = reinterpret_cast<bf16*>(
      smem_raw + (outs - smem_addr(smem_raw)) + c * out_tile_bytes(BN));
  constexpr int kPitch = BN + 8;         // the epilogue tile's row, bf16
  // a thread's 16-byte chunks of the epilogue lie in one column, kStep
  // rows apart
  constexpr int kChunks = BN / 8;
  constexpr int kStep = 128 / kChunks;
  constexpr int kPer = kTileM / kStep;
  const int col = (tid % kChunks) * 8;
  const int r0 = tid / kChunks;

  for (int i = c, turns = 0; blockIdx.x + i * gridDim.x < tiles;
       i += 2, ++turns) {
    const int t = blockIdx.x + i * gridDim.x;
    const int m0 = t / tiles_n * kTileM;
    const int n0 = t % tiles_n * BN;
    // this tile's k-steps hold queue positions i * steps, ...
    const int p0 = i * steps;
    int s = p0 % stages;
    uint32_t phase = (p0 / stages) & 1;
    int prev = s;
    float acc[2][BN / 2];  // the two 64-row halves
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[h][j] = 0.f;
    // the other consumer has finished the products of tile i - 1
    if (i > 0) mbar_wait(turn + 8 * c, (c == 0 ? turns - 1 : turns) & 1);
    for (int kb = 0; kb < steps; ++kb) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t a = ring + s * bytes;
      const uint32_t b = a + kABytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTileK / 16; ++k) {
        // A: K-major, 8-row groups 1024 bytes apart, k-steps of 16 are
        // 32 bytes into the swizzle row, the second half 64 rows (8 KB)
        // on. B: MN-major, 64-column boxes kBoxBytes apart (leading),
        // 8-row k groups 1024 apart (stride), k-steps of 16 rows 2048
        // bytes apart.
        const uint64_t bd = sw128_desc(b + 2048 * k, kBoxBytes, 1024);
        wgmma<BN>(acc[0], sw128_desc(a + 32 * k, 16, 1024), bd);
        wgmma<BN>(acc[1], sw128_desc(a + 8192 + 32 * k, 16, 1024), bd);
      }
      wgmma_commit();
      // the previous k-step's products are done: its stage is free, and
      // this k-step's stay in flight while the next one's wait
      wgmma_wait<1>();
      if (kb > 0 && tid == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (tid == 0) {
      mbar_arrive(empty + 8 * prev);
      mbar_arrive(turn + 8 * (1 - c));
    }
    reg_fence(acc[0]);
    reg_fence(acc[1]);

    // epilogue, through this consumer's tile in shared memory: the fp32
    // sums rounded to bf16 (the first rounding of epilogues 3 and 5), then
    // the warpgroup walks the tile in 16-byte chunks, so the bias,
    // QuickGELU and residual code is one short loop and the stores are
    // whole 16-byte pieces
    const int rows = min(kTileM, M - m0);
    const int64_t o0 = static_cast<int64_t>(m0 + r0) * N + n0 + col;
    uint4 xv[kFc ? 1 : kPer];  // the residual, loaded early
    if constexpr (!kFc) {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (r0 + k * kStep < rows)
          xv[k] = *reinterpret_cast<const uint4*>(x + o0 + k * kStep * N);
    }
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + n0 + col);
    const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
    named_sync(1 + c, 128);  // the last tile's chunks are all read
    {
      // accumulator layout: warp w holds rows 16 w + g and + 8 of each
      // half, columns 8 j + 2 t and + 1 of each 8-column group j
      const int lane = tid & 31;
      const int rw = (tid >> 5) * 16 + (lane >> 2);
      const int cw = 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<__nv_bfloat162*>(
                tile + (64 * h + rw + 8 * half) * kPitch + 8 * j + cw) =
                __floats2bfloat162_rn(acc[h][4 * j + 2 * half],
                                      acc[h][4 * j + 2 * half + 1]);
    }
    named_sync(1 + c, 128);
#pragma unroll(kFc ? 2 : kPer)
    for (int k = 0; k < kPer; ++k) {
      if (r0 + k * kStep >= rows) break;
      const uint4 hv = *reinterpret_cast<const uint4*>(
          tile + (r0 + k * kStep) * kPitch + col);
      const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&hv);
      uint4 ov;
      __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 hf = __bfloat1622float2(hp[e]);
        const float2 bf = __bfloat1622float2(bp[e]);
        const __nv_bfloat162 v = __floats2bfloat162_rn(hf.x + bf.x,
                                                       hf.y + bf.y);
        if constexpr (kFc) {
          res[e] = quick_gelu2(v);
        } else {
          const float2 vf = __bfloat1622float2(v);
          const float2 xf = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&xv[k])[e]);
          res[e] = __floats2bfloat162_rn(xf.x + vf.x, xf.y + vf.y);
        }
      }
      *reinterpret_cast<uint4*>(out + o0 + k * kStep * N) = ov;
    }
  }
}

template <int BN, bool kFc>
cudaError_t launch_tile(const CUtensorMap& a, const CUtensorMap& b,
                        const bf16* bias, const bf16* x, bf16* out, int M,
                        int N, int K, int stages, int blocks, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel_tile<BN, kFc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlp_block_kernel_tile<BN, kFc><<<blocks, kTileThreads, smem, stream>>>(
      a, b, bias, x, out, M, N, K, stages);
  return cudaGetLastError();
}

template <bool kFc>
cudaError_t launch_tile_bn(int bn, const CUtensorMap& a, const CUtensorMap& b,
                           const bf16* bias, const bf16* x, bf16* out, int M,
                           int N, int K, int stages, int blocks, size_t smem,
                           cudaStream_t stream) {
  if (bn == 64)
    return launch_tile<64, kFc>(a, b, bias, x, out, M, N, K, stages, blocks,
                                smem, stream);
  if (bn == 128)
    return launch_tile<128, kFc>(a, b, bias, x, out, M, N, K, stages,
                                 blocks, smem, stream);
  return cudaErrorInvalidValue;
}

// a tile product's geometry as the plan gave it, against this file's rules
bool tile_ok(int bn, int N, int stages, int blocks, size_t smem) {
  return (bn == 64 || bn == 128) && N % bn == 0 && stages >= 2 &&
         blocks >= 1 && smem == tile_smem_bytes(bn, stages) &&
         smem <= kMaxSmem;
}

}  // namespace

extern "C" {

size_t lossyless_mlp_block_smem_bytes(int D) {
  return sizeof(bf16) * layout(D).total;
}

// K4, the mma.sync design. x (M, D) bf16, ln_scale/ln_bias (D) fp32,
// fc_w (D, H) bf16, fc_b (H) bf16, pr_w (H, D) bf16, pr_b (D) bf16, all
// contiguous and 16-byte aligned -> out (M, D) bf16. D % 8 == 0,
// D <= kMaxD, H % kChunk == 0.
int lossyless_fused_mlp_block(const void* x, const void* ln_scale,
                              const void* ln_bias, const void* fc_w,
                              const void* fc_b, const void* pr_w,
                              const void* pr_b, void* out, int M, int D,
                              int H, float eps, int device, void* stream) {
  if (M < 1 || D < 8 || D % 8 || D > kMaxD || H < kChunk || H % kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = lossyless_mlp_block_smem_bytes(D);
  err = cudaFuncSetAttribute(mlp_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  mlp_block_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(fc_w),
      static_cast<const bf16*>(fc_b), static_cast<const bf16*>(pr_w),
      static_cast<const bf16*>(pr_b), static_cast<bf16*>(out), M, D, H, eps);
  return static_cast<int>(cudaGetLastError());
}

size_t lossyless_mlp_block_tile_smem_bytes(int n_tile, int stages) {
  return tile_smem_bytes(n_tile, stages);
}

// K4, the wgmma design. x (M, D) bf16, ln_scale/ln_bias (D) fp32, fc_w
// (D, H) bf16, fc_b (H) bf16, pr_w (H, D) bf16, pr_b (D) bf16, all
// contiguous and 16-byte aligned -> out (M, D) bf16; y (M, D) and hidden
// (M, H) bf16 are the caller's scratch. D % 64 == 0, H % 64 == 0. Each
// product's plan (fc: N = H; proj: N = D) is four ints: n_tile, stages,
// blocks, shared memory bytes, which must be this file's. Three launches
// on `stream`.
int lossyless_fused_mlp_block_tile(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* fc_w, const void* fc_b, const void* pr_w, const void* pr_b,
    void* y, void* hidden, void* out, int M, int D, int H, float eps,
    const int* fc_plan, const int* proj_plan, int device, void* stream) {
  // plan: n_tile, stages, blocks, shared memory bytes
  const int* fc = fc_plan;
  const int* pr = proj_plan;
  if (M < 1 || D < 64 || D % 64 || H < 64 || H % 64 ||
      static_cast<int64_t>(M) * H >= (int64_t{1} << 31) ||
      !tile_ok(fc[0], H, fc[1], fc[2], fc[3]) ||
      !tile_ok(pr[0], D, pr[1], pr[2], pr[3]))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap y_map, fc_map, h_map, pr_map;
  if (!bf16_map(&y_map, y, D, M, kTileM) ||
      !bf16_map(&fc_map, fc_w, H, D, 64) ||
      !bf16_map(&h_map, hidden, H, M, kTileM) ||
      !bf16_map(&pr_map, pr_w, D, H, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mlp_block_kernel_ln<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                        st>>>(static_cast<const bf16*>(x),
                              static_cast<const float*>(ln_scale),
                              static_cast<const float*>(ln_bias),
                              static_cast<bf16*>(y), M, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_tile_bn<true>(fc[0], y_map, fc_map,
                             static_cast<const bf16*>(fc_b), nullptr,
                             static_cast<bf16*>(hidden), M, H, D, fc[1],
                             fc[2], fc[3], st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_tile_bn<false>(pr[0], h_map, pr_map,
                              static_cast<const bf16*>(pr_b),
                              static_cast<const bf16*>(x),
                              static_cast<bf16*>(out), M, D, H, pr[1], pr[2],
                              pr[3], st);
  return static_cast<int>(err);
}

}  // extern "C"
