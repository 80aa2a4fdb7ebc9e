// Factorized-prior (entropy bottleneck) likelihood, hand-written for Hopper.
//
// K3  lossyless_eb_likelihood  replaces the Pallas kernel
//     lossyless_tpu/coding/pallas_eb.py::eb_likelihood_fused (_kernel):
//     for each element z of a (batch, channels) tensor, run the channel's
//     chain  v <- softplus(M_l) v + b_l,  v <- v + tanh(f_l) tanh(v)  (all but
//     the last layer) at z - 0.5 and at z + 0.5, then the sign trick
//     |sigmoid(s*upper) - sigmoid(s*lower)| with s = -sign(lower + upper),
//     floored at 1e-9.
//
// Design. The TPU kernel works on (8 channel, 128 batch) tiles of a
// channel-major copy of z. Here z is read in the callers' (batch, channels)
// row-major layout directly, so neither direction needs a transpose: one
// thread per element, neighbouring threads on neighbouring channels (each
// warp reads and writes 128 contiguous bytes). A block owns kChannels
// channels and kRows batch rows (one thread each); its threads first
// compute softplus(M) and tanh(f) of the block's channels ONCE into shared
// memory (channel-minor, so the threads of a warp read consecutive banks),
// then each thread runs the chain for its element. The chain is unrolled
// over W filters, W the widest filter rounded up to 1, 2, 3, 4 or 8 (a
// template parameter), with runtime guards for narrower layers, so any
// filter tuple up to width 8 runs with its state in registers.
//
// Bound on an H100 SXM (3.35 TB/s; fp32) at the slice shape B=128, C=512,
// filters (3,3,3,3): it reads 262 KB of z and 119 KB of coefficients and
// writes 262 KB: 0.19 us from memory; ~10 MFLOP is far below the fp32 rate.
// A launch is latency-bound: the design keeps it to one pass over z with
// no intermediate in device memory.
//
// Interface: plain C, loaded with ctypes. The launcher runs on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kRows = 4;       // batch rows per block: blockDim = 256
constexpr int kMaxWidth = 8;   // widest filter the unrolled chain takes
constexpr int kMaxLayers = 8;
constexpr float kBound = 1e-9f;

struct Dims {
  int n_layers;
  int width[kMaxLayers + 1];  // 1, filters..., 1
};

// Coefficients per channel, in the order the wrapper packs them:
// for each layer l: matrix (out x in, row-major), bias (out), factor (out,
// all layers but the last).
__host__ __device__ inline int n_coeffs(const Dims& d) {
  int k = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    k += d.width[l + 1] * d.width[l] + d.width[l + 1];
    if (l < d.n_layers - 1) k += d.width[l + 1];
  }
  return k;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The chain at value v for the thread's channel; w points at its first
// coefficient, consecutive coefficients kChannels floats apart. W >= every
// filter width.
template <int W>
__device__ __forceinline__ float chain(float v, const float* w,
                                       const Dims& d) {
  float s[W];
  s[0] = v;
  int d_in = 1;
  for (int l = 0; l < d.n_layers; ++l) {
    const int d_out = d.width[l + 1];
    const float* m = w;
    const float* b = m + d_out * d_in * kChannels;
    float ns[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < d_out) {
        float acc = b[j * kChannels];
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < d_in) acc = fmaf(m[(j * d_in + k) * kChannels], s[k], acc);
        ns[j] = acc;
      }
    }
    w = b + d_out * kChannels;
    if (l < d.n_layers - 1) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j < d_out) ns[j] = fmaf(w[j * kChannels], tanhf(ns[j]), ns[j]);
      w += d_out * kChannels;
    }
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (j < d_out) s[j] = ns[j];
    d_in = d_out;
  }
  return s[0];
}

// blockIdx.x: channel tile, blockIdx.y: row tile; thread (c, r) =
// (threadIdx.x % kChannels, threadIdx.x / kChannels). coeffs (C, K).
template <int W>
__global__ void __launch_bounds__(kChannels * kRows)
    eb_likelihood_kernel(const float* __restrict__ z,
                         const float* __restrict__ coeffs,
                         float* __restrict__ out, int B, int C, Dims d) {
  extern __shared__ float w[];  // (K, kChannels): softplus/tanh applied
  const int K = n_coeffs(d);
  const int c0 = blockIdx.x * kChannels;
  const int n_ch = min(kChannels, C - c0);

  // the transform of each coefficient: 0 = as is, 1 = softplus, 2 = tanh
  for (int idx = threadIdx.x; idx < n_ch * K; idx += blockDim.x) {
    const int c = idx / K;
    const int k = idx - c * K;
    int kind = 0, off = 0;
    for (int l = 0; l < d.n_layers; ++l) {
      const int n_m = d.width[l + 1] * d.width[l];
      const int n_b = d.width[l + 1];
      const int n_f = l < d.n_layers - 1 ? d.width[l + 1] : 0;
      if (k < off + n_m) { kind = 1; break; }
      if (k < off + n_m + n_b) { kind = 0; break; }
      if (k < off + n_m + n_b + n_f) { kind = 2; break; }
      off += n_m + n_b + n_f;
    }
    const float x = coeffs[static_cast<int64_t>(c0 + c) * K + k];
    w[k * kChannels + c] = kind == 1 ? softplus(x) : kind == 2 ? tanhf(x) : x;
  }
  __syncthreads();

  const int c = threadIdx.x % kChannels;
  const int r = blockIdx.y * kRows + threadIdx.x / kChannels;
  if (c >= n_ch || r >= B) return;
  const int64_t i = static_cast<int64_t>(r) * C + c0 + c;
  const float v = z[i];
  const float lower = chain<W>(v - 0.5f, w + c, d);
  const float upper = chain<W>(v + 0.5f, w + c, d);
  const float t = lower + upper;
  const float sign = t > 0.f ? -1.f : (t < 0.f ? 1.f : 0.f);
  const float lik = fabsf(sigmoid(sign * upper) - sigmoid(sign * lower));
  out[i] = fmaxf(lik, kBound);
}

template <int W>
void launch(const float* z, const float* coeffs, float* out, int B, int C,
            const Dims& d, size_t smem, cudaStream_t stream) {
  const dim3 grid((C + kChannels - 1) / kChannels, (B + kRows - 1) / kRows);
  eb_likelihood_kernel<W><<<grid, kChannels * kRows, smem, stream>>>(
      z, coeffs, out, B, C, d);
}

}  // namespace

extern "C" {

// Shared memory one block needs for K coefficients per channel.
size_t lossyless_eb_smem_bytes(int n_coeffs_per_channel) {
  return sizeof(float) * static_cast<size_t>(n_coeffs_per_channel) *
         kChannels;
}

int lossyless_eb_max_width() { return kMaxWidth; }
int lossyless_eb_max_layers() { return kMaxLayers; }

// K3. z (B, C) fp32 contiguous, coeffs (C, K) fp32 contiguous packed as
// n_coeffs() describes, widths[0..n_layers] = (1, filters..., 1)
// -> out (B, C) fp32.
int lossyless_eb_likelihood(const void* z, const void* coeffs, void* out,
                            int B, int C, int n_layers, const int* widths,
                            int device, void* stream) {
  if (B < 1 || C < 1 || n_layers < 1 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  d.n_layers = n_layers;
  int widest = 1;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    d.width[l] = widths[l];
    widest = widths[l] > widest ? widths[l] : widest;
  }
  if (d.width[0] != 1 || d.width[n_layers] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lossyless_eb_smem_bytes(n_coeffs(d));
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* zf = static_cast<const float*>(z);
  const auto* cf = static_cast<const float*>(coeffs);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (widest <= 1) launch<1>(zf, cf, of, B, C, d, smem, s);
  else if (widest == 2) launch<2>(zf, cf, of, B, C, d, smem, s);
  else if (widest == 3) launch<3>(zf, cf, of, B, C, d, smem, s);
  else if (widest == 4) launch<4>(zf, cf, of, B, C, d, smem, s);
  else launch<kMaxWidth>(zf, cf, of, B, C, d, smem, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
