// Fused MLP half-block of a pre-LN transformer, hand-written for Hopper.
//
// K4  lossyless_fused_mlp_block  replaces the Pallas kernel
//     lossyless_tpu/nn/flash_attn.py::fused_mlp_block (_mlp_kernel):
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
// Design. The TPU kernel keeps both weight matrices resident in VMEM
// (~9.4 MB); an SM has 227 KB of shared memory. So a block (CTA) owns
// kRowsPerBlock = 32 token rows and streams the weights past them:
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
// row addresses of each ldmatrix hit distinct banks.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the slice
// shape M = 128 x 50 = 6,400, D = 768, H = 3,072: 4 M D H = 60.4 GFLOP,
// 0.061 ms; it moves ~29 MB (x in, out, both weights once), 0.009 ms. The
// tensor cores bound it. The block re-reads the weights from L2 (200 blocks
// x 9.4 MB); wgmma, TMA multicast across a cluster and larger row tiles are
// for a later design.
//
// Interface: plain C, loaded with ctypes. The launcher runs on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

}  // namespace

extern "C" {

size_t lossyless_mlp_block_smem_bytes(int D) {
  return sizeof(bf16) * layout(D).total;
}

int lossyless_mlp_block_max_d() { return kMaxD; }
int lossyless_mlp_block_chunk() { return kChunk; }

// K4. x (M, D) bf16, ln_scale/ln_bias (D) fp32, fc_w (D, H) bf16,
// fc_b (H) bf16, pr_w (H, D) bf16, pr_b (D) bf16, all contiguous and
// 16-byte aligned -> out (M, D) bf16. D % 8 == 0, D <= kMaxD,
// H % kChunk == 0.
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

}  // extern "C"
