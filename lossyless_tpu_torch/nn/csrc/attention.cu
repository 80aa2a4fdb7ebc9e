// Multi-head attention for short token sequences, hand-written for Hopper.
//
// K1  lossyless_fused_attention      replaces the Pallas kernel
//     lossyless_tpu/nn/flash_attn.py::fused_attention (_attn_kernel):
//     MHSA straight off the fused qkv projection, (B, N, 3D) -> (B, N, D).
// K2  lossyless_fused_attention_cls  replaces
//     lossyless_tpu/nn/flash_attn.py::fused_attention_cls (_attn_cls_kernel):
//     the same attention for the class-token query only,
//     q0 (B, 1, D) and kv (B, N, 2D) -> (B, 1, D).
//
// Arithmetic (the TPU kernels', not a block-by-block copy of them): q.k is
// accumulated in fp32 and multiplied by d^-1/2 AFTER the dot; row max, exp
// and sum in fp32; probabilities normalized as p / sum, cast to the io
// dtype, then P.V accumulated in fp32 and stored in the io dtype. io dtype
// is bf16 or fp32, head dim d <= 128, N limited only by shared memory.
//
// Design (simple: FMA on CUDA cores, no tensor cores yet). One block per
// (image, head). The block stages that head's Q, K and V slices from the
// natural layout into shared memory as fp32 (exact for bf16 inputs), with
// 16-byte global loads where the layout allows, zero-padding rows to a
// multiple of 4 and columns to a multiple of 4 (exact: the pads add zeros).
// Each warp then takes 4 query rows at a time:
//   q.k   lane j owns key j; one float4 of K row j feeds 16 FMAs (4 rows x
//         4 columns) against float4 broadcasts of the 4 query rows. The row
//         pitch is a multiple of 4 whose quarter is odd, so the 8 lanes of a
//         quarter-warp reading rows j..j+7 hit all 32 banks.
//   softmax  warp shuffles give each row's max and sum.
//   P.V   lane owns column pairs (2*lane, +1) and (+64); float2 of V against
//         float4 broadcasts of 4 probabilities per row.
// The sum over the head dim and over the keys runs in index order.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the CLIP
// ViT-B/32 slice shapes B=512, N=50, h=12, d=64, bf16:
//   K1 reads 118.0 MB of qkv and writes 39.3 MB: 47 us from memory; its
//      3.9 GFLOP would take 4 us at the bf16 tensor-core rate. Memory-bound.
//   K2 reads 78.6 MB of kv (+0.8 MB q0) and writes 0.8 MB: 24 us.
//      Memory-bound.
// What the design does about it: every input byte is read from device
// memory once (the block's staging) and every output byte written once;
// logits and probabilities never leave the SM. On CUDA cores the dots cost
// shared-memory bandwidth, which the register tiling above keeps below the
// staging time at N=50; measured times are in PERF.md (from chip_smoke.py).
// Later: mma/wgmma for the dots, several heads per block, TMA staging.
//
// Interface: plain C, loaded with ctypes. Each launcher runs on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxD = 128;
constexpr int kRows = 4;  // query rows per warp step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// blockIdx.x = image b, blockIdx.y = head h. q/k/v/out point at head 0 of
// image 0; the *_batch strides step images, the *_row strides tokens.
template <typename T>
__global__ void attention_kernel(const T* __restrict__ q, int64_t q_batch,
                                 int64_t q_row, int n_q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, int64_t kv_batch,
                                 int64_t kv_row, T* __restrict__ out,
                                 int64_t out_batch, int64_t out_row, int N,
                                 int d, float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const Layout L = layout(n_q, N, d, n_warps);
  const int ld = L.ld, n4 = L.n4, d4 = round_up(d, 4);
  float* qs = smem;
  float* ks = smem + L.k;
  float* vs = smem + L.v;
  float* ps = smem + L.p + static_cast<size_t>(warp) * kRows * n4;

  // the padding rows and columns of Q, K and V must read as zero
  for (size_t i = threadIdx.x; i < L.p; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  const int64_t b = blockIdx.x;
  const int64_t hd = static_cast<int64_t>(blockIdx.y) * d;
  stage(qs, ld, q + b * q_batch + hd, q_row, n_q, d, vec);
  stage(ks, ld, k + b * kv_batch + hd, kv_row, N, d, vec);
  stage(vs, ld, v + b * kv_batch + hd, kv_row, N, d, vec);
  __syncthreads();
  T* ob = out + b * out_batch + hd;

  for (int i0 = warp * kRows; i0 < n_q; i0 += n_warps * kRows) {
    const float* qr = qs + i0 * ld;

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
        const float l = acc[r] * scale;
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
        const float e = expf(ps[r * n4 + j] - m[r]);
        ps[r * n4 + j] = e;
        s[r] += e;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = warp_sum(s[r]);
    // normalize, round to the io dtype; the padding keys get probability 0
    for (int j = lane; j < n4; j += kWarp) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ps[r * n4 + j] =
            j < N ? to_f32(from_f32<T>(ps[r * n4 + j] / s[r])) : 0.f;
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
}

size_t smem_bytes(int n_q, int N, int d, int n_warps) {
  return sizeof(float) * layout(n_q, N, d, n_warps).total;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* q, int64_t q_batch, int64_t q_row, int n_q,
           const void* k, const void* v, int64_t kv_batch, int64_t kv_row,
           void* out, int64_t out_batch, int64_t out_row, int B, int N,
           int heads, int d, float scale, int n_warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_q, N, d, n_warps);
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte staging loads: every row start is then 16-byte aligned too,
  // since d (hence every head offset and row stride) is a multiple of kVec
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v);
  attention_kernel<T><<<dim3(B, heads), n_warps * kWarp, smem, stream>>>(
      static_cast<const T*>(q), q_batch, q_row, n_q,
      static_cast<const T*>(k), static_cast<const T*>(v), kv_batch, kv_row,
      static_cast<T*>(out), out_batch, out_row, N, d, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, const void* q, int64_t q_batch, int64_t q_row,
             int n_q, const void* k, const void* v, int64_t kv_batch,
             int64_t kv_row, void* out, int64_t out_batch, int64_t out_row,
             int B, int N, int heads, int d, float scale, int n_warps,
             int device, void* stream) {
  if (d < 1 || d > kMaxD || N < 1 || B < 1 || heads < 1 || n_warps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, q_batch, q_row, n_q, k, v, kv_batch, kv_row, out,
                         out_batch, out_row, B, N, heads, d, scale, n_warps,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, q_batch, q_row, n_q, k, v, kv_batch,
                                 kv_row, out, out_batch, out_row, B, N, heads,
                                 d, scale, n_warps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory one block needs, for the wrapper's shape check.
size_t lossyless_attention_smem_bytes(int n_q, int N, int d, int n_warps) {
  return smem_bytes(n_q, N, d, n_warps);
}

// K1. qkv (B, N, 3*heads*d) contiguous -> out (B, N, heads*d).
// dtype: 0 = float32, 1 = bfloat16.
int lossyless_fused_attention(const void* qkv, void* out, int B, int N,
                              int heads, int d, int dtype, float scale,
                              int n_warps, int device, void* stream) {
  const int64_t D = static_cast<int64_t>(heads) * d;
  const size_t es = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  return dispatch(dtype, base, N * 3 * D, 3 * D, N, base + D * es,
                  base + 2 * D * es, N * 3 * D, 3 * D, out, N * D, D, B, N,
                  heads, d, scale, n_warps, device, stream);
}

// K2. q0 (B, 1, heads*d), kv (B, N, 2*heads*d) contiguous -> out (B, 1, heads*d).
int lossyless_fused_attention_cls(const void* q0, const void* kv, void* out,
                                  int B, int N, int heads, int d, int dtype,
                                  float scale, int n_warps, int device,
                                  void* stream) {
  const int64_t D = static_cast<int64_t>(heads) * d;
  const size_t es = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(kv);
  return dispatch(dtype, q0, D, D, 1, base, base + D * es, N * 2 * D, 2 * D,
                  out, D, D, B, N, heads, d, scale, n_warps, device, stream);
}

}  // extern "C"
