// BatchNorm's forward and backward, hand-written for Hopper: K6.
//
// K6      lossyless_bn_stats, then lossyless_bn_normalize: flax's
//         nn.BatchNorm (momentum 0.9) over every dim but the channels',
//         the port's nn/layers.py::BatchNorm. In training mode the
//         per-channel E[x] and E[x^2] of the batch, flax's fast variance
//         var = max(E[x^2] - E[x]^2, 0) (layers.py::_fast_stats), rstd =
//         rsqrt(var + eps), the running mean and var updated in place, and
//         y = (x - mean) rstd scale + bias; in eval mode the last step with
//         the running statistics. x bf16 or fp32, everything else fp32, y
//         fp32.
// K6 bwd  lossyless_bn_grad_sums, then lossyless_bn_dx: the VJP of that
//         function. Per channel S1 = sum dy (dbias) and S2 = sum dy xhat
//         (dscale); dx = scale rstd dy + K0 + K1 (x - mean), the two terms
//         being the gradient through E[x] and E[x^2] as autograd gives it
//         through the chain above: K0 = -rstd scale S1 / n, K1 = 2 gvar / n,
//         gvar = -rstd^2 scale S2 / 2 where the clamp passed its input
//         (E[x^2] - E[x]^2 >= 0, torch.clamp's rule), else 0; in eval mode
//         K0 = K1 = 0. dx is rounded once to x's dtype.
//
// No TPU kernel is replaced: on the TPU, XLA fuses flax's BatchNorm into
// the convolutions' neighbours. On the card the eager chain (a cast, x * x,
// two means, the subtraction, rsqrt, the scale and bias, and autograd's
// walk back through each) reads and writes an fp32 tensor of the
// activation's size a dozen times a call.
//
// Bound. Training moves at least x in (bf16: 2 B an element) and y out
// (4 B) forward, x and dy in (2 + 4 B) and dx out (2 B) backward: 14 B an
// element, 8 + 12 = 20 B at fp32 in. A step of stl10_bince (two views of
// 256 images at 96 px through ResNet-18's small stem) runs 40 calls over
// 2.83 G elements: 39.6 GB, 11.8 ms at 3.35 TB/s. The statistics need the
// whole batch before any output can be written, and a call's x (up to
// 302 MB at the stem) is far larger than the L2 cache and the SMs' shared
// memory together, so the design reads x twice forward and x and dy twice
// backward: 22 B an element (30 at fp32), 18.6 ms a step at peak.
//
// Design. x is (rows, C) with the channels innermost (a channels_last
// 4-D tensor, or a (B, C) matrix); its rows may be a view over up to three
// strided dims (a cropped transposed convolution's output), y, dy and dx
// are dense (rows, C). Every row kernel gives a block one row tile x one
// channel slice: tc threads along the channels, each owning V channels
// (16 bytes of x: 8 bf16 or 4 fp32, else 1 channel) for the whole call, and
// tr = 256 / tc threads along the rows, so a warp reads whole rows, 16
// bytes a thread. A thread keeps its channels' constants and partial sums
// in registers and walks rows ty, ty + tr, ... of its tile. The grid is one
// wave of equal tiles: at most kResident blocks an SM, which the register
// cap of __launch_bounds__ guarantees the SM holds at once, so no block
// waits for a tail (on an H100 this took the stem's normalize from 0.361
// to 0.326 ms against tiles of 16 blocks an SM; deeper unrolling and 4
// blocks an SM changed nothing).
//
// The reductions are deterministic, with no atomics: each thread sums its
// rows in order; the block sums its row lanes in order through shared
// memory into its tile's slot of a (tiles, 2, C) scratch; the finalize
// kernel's 32 tile lanes each sum tiles lane, lane + 32, ... in order, then
// the lanes are summed in order. Between the finalize and the elementwise
// pass the (2, C) sums are where a data-parallel step all-reduces them
// (the wrapper). The normalize kernel computes each channel's mean, rstd
// and clamp flag from the sums in every block (C-sized reads) and its
// first row tile writes them and the running statistics.
//
// Interface: plain C, loaded with ctypes. A launcher runs on the given
// stream on the current device, does not synchronise and returns
// cudaGetLastError() (cudaErrorInvalidValue for a geometry it does not
// take). The wrapper's plan (nn/bn_kernel.py::bn_plan) gives the geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A named namespace: the C interface takes Geometry by value, and a type of
// an unnamed namespace would give those functions internal linkage.
namespace lossyless_bn {

constexpr int kThreads = 256;  // threads a block of the row kernels
constexpr int kLanes = 32;     // threads a block along the channels, at most
constexpr int kMaxVec = 8;     // channels a thread owns, at most
constexpr int kFinalX = 32;    // finalize: sums a block, one a lane
constexpr int kFinalY = 32;    // finalize: lanes splitting the tiles
// blocks of a row kernel an SM holds at once, at least (its registers are
// capped for it): the plan's grid is one such wave, so every block runs
// from the start and none is left for a tail
constexpr int kResident = 3;
constexpr int kBf16 = 0, kF32 = 1;
// the partial kernel's block sums: two quantities a channel a row lane
constexpr int kRedFloats = 2 * kThreads * kMaxVec;

// The call's shape and launch geometry (bn_plan). Row r of x is at element
// i0 s0 + i1 s1 + i2 s2 with (i0, i1, i2) = r's digits in sizes (., d1,
// d2); dense: at r C.
struct Geometry {
  long long rows;
  long long s0, s1, s2;
  int d1, d2;
  int C;
  int dtype;  // kBf16 or kF32
  int vec;    // channels a thread: 16 / sizeof(x's element), or 1
  int dense;
  int tc, tr;  // threads a block along the channels, along the rows
  int rows_per_tile, tiles, slices;
};

// The normalize kernel's scalars: the ranks whose means the sums hold (1
// outside a data-parallel step), eps, the running statistics' momentum and
// 1 - momentum (fp32, as torch rounds the Python floats), training or eval.
struct Norm {
  float world, eps, momentum, one_minus_momentum;
  int training;
};

__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(__nv_bfloat16 a) {
  return __bfloat162float(a);
}

template <typename T>
__device__ __forceinline__ T from_float(float a);
template <>
__device__ __forceinline__ float from_float<float>(float a) {
  return a;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

// x's element offset of row r
template <bool kDense>
__device__ __forceinline__ long long row_offset(const Geometry& g,
                                                long long r) {
  if (kDense) return r * g.C;
  const int q = static_cast<int>(r);  // rows <= INT_MAX (bn_plan)
  const int i2 = q % g.d2, t = q / g.d2;
  const int i1 = t % g.d1, i0 = t / g.d1;
  return i0 * g.s0 + i1 * g.s1 + i2 * g.s2;
}

// V elements of x (V = 1, or 16 bytes) as fp32
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* p, float (&v)[V]) {
  static_assert(V == 1 || V * sizeof(T) == 16, "1 element or 16 bytes");
  if constexpr (V == 1) {
    v[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// V elements in x's dtype, each rounded once from fp32
template <typename T, int V>
__device__ __forceinline__ void store_x(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 2) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// V fp32 values (V = 1 or a multiple of 4)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(
          v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// Per-tile sums of a channel slice: (x, x^2) forward, (dy, dy xhat) with
// xhat = (x - mean) rstd backward (kGrad), into partials (tiles, 2, C).
template <typename T, int V, bool kDense, bool kGrad>
__global__ void __launch_bounds__(kThreads, kResident)
    bn_partial_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                      const float* __restrict__ stats,
                      float* __restrict__ partials, Geometry g) {
  __shared__ float red[kRedFloats];
  const int tx = threadIdx.x % g.tc, ty = threadIdx.x / g.tc;
  const int cw = g.tc * V;          // channels a block
  const int cb = blockIdx.x * cw;   // the block's first channel
  const int c0 = cb + tx * V;       // the thread's first channel
  const long long r0 = static_cast<long long>(blockIdx.y) * g.rows_per_tile;
  const long long r1 = min(g.rows, r0 + g.rows_per_tile);
  float a[V], b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = b[v] = 0.f;
  if (ty < g.tr && c0 < g.C) {
    float mean[V], rstd[V];
    if constexpr (kGrad) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mean[v] = stats[c0 + v];
        rstd[v] = stats[g.C + c0 + v];
      }
    }
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += g.tr) {
      float xv[V];
      load_x<T, V>(x + row_offset<kDense>(g, r) + c0, xv);
      if constexpr (kGrad) {
        float gv[V];
        load_f32<V>(dy + r * g.C + c0, gv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          a[v] += gv[v];
          b[v] += gv[v] * ((xv[v] - mean[v]) * rstd[v]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          a[v] += xv[v];
          b[v] += xv[v] * xv[v];
        }
      }
    }
  }
  const int lane_floats = g.tr * cw;  // one quantity's block of sums
  if (ty < g.tr) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[ty * cw + tx * V + v] = a[v];
      red[lane_floats + ty * cw + tx * V + v] = b[v];
    }
  }
  __syncthreads();
  // each (quantity, channel) of the slice: its row lanes in order
  for (int j = threadIdx.x; j < 2 * cw; j += blockDim.x) {
    const int q = j / cw, cc = j % cw;
    if (cb + cc >= g.C) continue;
    const float* lanes = red + q * lane_floats + cc;
    float s = 0.f;
    for (int k = 0; k < g.tr; ++k) s += lanes[k * cw];
    partials[(static_cast<long long>(blockIdx.y) * 2 + q) * g.C + cb + cc] =
        s;
  }
}

// sums (n = 2 C) = the partials (tiles, n) summed over the tiles, divided
// by denom: lane y of a block sums tiles y, y + kFinalY, ... in order, then
// the lanes are summed in order.
__global__ void __launch_bounds__(kFinalX* kFinalY)
    bn_finalize_kernel(const float* __restrict__ partials,
                       float* __restrict__ sums, int tiles, int n,
                       float denom) {
  __shared__ float red[kFinalY][kFinalX];
  const int j = blockIdx.x * kFinalX + threadIdx.x;
  float s = 0.f;
  if (j < n) {
#pragma unroll 8
    for (int t = threadIdx.y; t < tiles; t += kFinalY)
      s += partials[static_cast<long long>(t) * n + j];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float total = 0.f;
    for (int k = 0; k < kFinalY; ++k) total += red[k][threadIdx.x];
    sums[j] = total / denom;
  }
}

// y = (x - mean) rstd scale + bias, rounded at each step as the eager chain
// does. sums (2, C): each rank's E[x] and E[x^2] summed over the ranks
// (training), divided here by their number as layers.py::_batch_stats
// does; stats (3, C) out: mean, rstd, the clamp's flag.
template <typename T, int V, bool kDense>
__global__ void __launch_bounds__(kThreads, kResident)
    bn_normalize_kernel(const T* __restrict__ x, float* __restrict__ y,
                        const float* __restrict__ sums,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float* run_mean,
                        float* run_var, float* __restrict__ stats, Geometry g,
                        Norm p) {
  const int tx = threadIdx.x % g.tc, ty = threadIdx.x / g.tc;
  const int c0 = (blockIdx.x * g.tc + tx) * V;
  if (ty >= g.tr || c0 >= g.C) return;
  float mean[V], rstd[V], sc[V], bi[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = c0 + v;
    float m, var, live = 1.f;
    if (p.training) {
      m = sums[c] / p.world;
      const float raw = __fsub_rn(sums[g.C + c] / p.world, __fmul_rn(m, m));
      var = raw < 0.f ? 0.f : raw;  // torch.clamp(min=0): NaN stays NaN
      live = raw >= 0.f ? 1.f : 0.f;
    } else {
      m = run_mean[c];
      var = run_var[c];
    }
    const float r = rsqrtf(__fadd_rn(var, p.eps));
    mean[v] = m;
    rstd[v] = r;
    sc[v] = scale[c];
    bi[v] = bias[c];
    if (blockIdx.y == 0 && ty == 0) {
      stats[c] = m;
      stats[g.C + c] = r;
      stats[2 * g.C + c] = live;
      if (p.training) {
        run_mean[c] = __fadd_rn(__fmul_rn(run_mean[c], p.momentum),
                                __fmul_rn(p.one_minus_momentum, m));
        run_var[c] = __fadd_rn(__fmul_rn(run_var[c], p.momentum),
                               __fmul_rn(p.one_minus_momentum, var));
      }
    }
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * g.rows_per_tile;
  const long long r1 = min(g.rows, r0 + g.rows_per_tile);
#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += g.tr) {
    float xv[V], out[V];
    load_x<T, V>(x + row_offset<kDense>(g, r) + c0, xv);
#pragma unroll
    for (int v = 0; v < V; ++v)
      out[v] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(xv[v], mean[v]), rstd[v]), sc[v]),
          bi[v]);
    store_f32<V>(y + r * g.C + c0, out);
  }
}

// dx = scale rstd dy + K0 + K1 (x - mean) in x's dtype. sums (2, C): S1
// and S2 summed over the ranks; count: rows of the global batch.
template <typename T, int V, bool kDense>
__global__ void __launch_bounds__(kThreads, kResident)
    bn_dx_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                 T* __restrict__ dx, const float* __restrict__ sums,
                 const float* __restrict__ stats,
                 const float* __restrict__ scale, Geometry g, float count,
                 int stat_grads) {
  const int tx = threadIdx.x % g.tc, ty = threadIdx.x / g.tc;
  const int c0 = (blockIdx.x * g.tc + tx) * V;
  if (ty >= g.tr || c0 >= g.C) return;
  float mean[V], A[V], K0[V], K1[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = c0 + v;
    const float r = stats[g.C + c], s = scale[c];
    mean[v] = stats[c];
    A[v] = s * r;
    K0[v] = K1[v] = 0.f;
    if (stat_grads) {
      const float gvar = -0.5f * r * r * s * sums[g.C + c] * stats[2 * g.C + c];
      K0[v] = -r * s * sums[c] / count;
      K1[v] = 2.f * gvar / count;
    }
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * g.rows_per_tile;
  const long long r1 = min(g.rows, r0 + g.rows_per_tile);
#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += g.tr) {
    float xv[V], gv[V], out[V];
    load_x<T, V>(x + row_offset<kDense>(g, r) + c0, xv);
    load_f32<V>(dy + r * g.C + c0, gv);
#pragma unroll
    for (int v = 0; v < V; ++v)
      out[v] = A[v] * gv[v] + K0[v] + K1[v] * (xv[v] - mean[v]);
    store_x<T, V>(dx + r * g.C + c0, out);
  }
}

// host side

template <typename T, int V, bool D>
struct Cfg {
  using type = T;
  static constexpr int vec = V;
  static constexpr bool dense = D;
};

// f(Cfg<x's type, V, dense>{}) for the geometry's instantiation
template <typename F>
cudaError_t dispatch(const Geometry& g, F f) {
  const bool d = g.dense != 0;
  if (g.dtype == kBf16 && g.vec == 8)
    return d ? f(Cfg<__nv_bfloat16, 8, true>{})
             : f(Cfg<__nv_bfloat16, 8, false>{});
  if (g.dtype == kBf16 && g.vec == 1)
    return d ? f(Cfg<__nv_bfloat16, 1, true>{})
             : f(Cfg<__nv_bfloat16, 1, false>{});
  if (g.dtype == kF32 && g.vec == 4)
    return d ? f(Cfg<float, 4, true>{}) : f(Cfg<float, 4, false>{});
  if (g.dtype == kF32 && g.vec == 1)
    return d ? f(Cfg<float, 1, true>{}) : f(Cfg<float, 1, false>{});
  return cudaErrorInvalidValue;
}

// whether the kernels take the geometry: the plan's invariants
bool takes(const Geometry& g) {
  if (g.rows < 1 || g.rows > 2147483647LL || g.C < 1) return false;
  if (g.tc < 1 || g.tc > kLanes || g.tr < 1 || g.tc * g.tr > kThreads)
    return false;
  if (g.vec != 1 && g.C % g.vec) return false;
  if (g.slices != (g.C + g.tc * g.vec - 1) / (g.tc * g.vec)) return false;
  if (g.rows_per_tile < 1 || g.tiles < 1 || g.tiles > 65535) return false;
  if (static_cast<long long>(g.tiles) * g.rows_per_tile < g.rows ||
      static_cast<long long>(g.tiles - 1) * g.rows_per_tile >= g.rows)
    return false;
  if (!g.dense && (g.d1 < 1 || g.d2 < 1)) return false;
  return true;
}

cudaError_t sums_of(const void* x, const float* dy, const float* stats,
                    bool grad, const Geometry& g, float* partials,
                    float* sums, float denom, cudaStream_t s) {
  if (!takes(g)) return cudaErrorInvalidValue;
  const dim3 grid(g.slices, g.tiles);
  cudaError_t e = dispatch(g, [&](auto cfg) {
    using K = decltype(cfg);
    using T = typename K::type;
    const T* xt = static_cast<const T*>(x);
    if (grad)
      bn_partial_kernel<T, K::vec, K::dense, true>
          <<<grid, kThreads, 0, s>>>(xt, dy, stats, partials, g);
    else
      bn_partial_kernel<T, K::vec, K::dense, false>
          <<<grid, kThreads, 0, s>>>(xt, dy, stats, partials, g);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  const int n = 2 * g.C;
  bn_finalize_kernel<<<(n + kFinalX - 1) / kFinalX, dim3(kFinalX, kFinalY),
                       0, s>>>(partials, sums, g.tiles, n, denom);
  return cudaGetLastError();
}

}  // namespace lossyless_bn

using namespace lossyless_bn;

extern "C" {

// The constants the wrapper's plan mirrors: threads a block, threads along
// the channels at most, channels a thread at most, the finalize's block
// (x, y), the partial kernel's static shared memory, the row kernels'
// resident blocks an SM.
void lossyless_bn_geometry(int* out) {
  out[0] = kThreads;
  out[1] = kLanes;
  out[2] = kMaxVec;
  out[3] = kFinalX;
  out[4] = kFinalY;
  out[5] = static_cast<int>(sizeof(float) * kRedFloats);
  out[6] = kResident;
}

// Forward, training: sums (2, C) = x's per-channel E[x] and E[x^2] over
// its rows, through partials (tiles, 2, C). Two launches.
int lossyless_bn_stats(const void* x, Geometry g, float* partials,
                       float* sums, cudaStream_t stream) {
  return static_cast<int>(sums_of(x, nullptr, nullptr, false, g, partials,
                                  sums, static_cast<float>(g.rows), stream));
}

// Forward: y (rows, C) fp32, stats (3, C); in training mode from sums and
// with the running statistics updated, else from the running statistics.
// One launch.
int lossyless_bn_normalize(const void* x, float* y, const float* sums,
                           const float* scale, const float* bias,
                           float* run_mean, float* run_var, float* stats,
                           Geometry g, Norm p, cudaStream_t stream) {
  if (!takes(g) || (p.training && sums == nullptr)) return cudaErrorInvalidValue;
  const dim3 grid(g.slices, g.tiles);
  return static_cast<int>(dispatch(g, [&](auto cfg) {
    using K = decltype(cfg);
    using T = typename K::type;
    bn_normalize_kernel<T, K::vec, K::dense><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), y, sums, scale, bias, run_mean, run_var,
        stats, g, p);
    return cudaGetLastError();
  }));
}

// Backward: sums (2, C) = per-channel S1 = sum dy and S2 = sum dy xhat, dy
// dense (rows, C) fp32, stats the forward's. Two launches.
int lossyless_bn_grad_sums(const void* x, const float* dy,
                           const float* stats, Geometry g, float* partials,
                           float* sums, cudaStream_t stream) {
  return static_cast<int>(
      sums_of(x, dy, stats, true, g, partials, sums, 1.f, stream));
}

// Backward: dx (rows, C) in x's dtype from dy, the forward's stats and S1,
// S2 summed over the ranks (sums; unread without stat_grads). One launch.
int lossyless_bn_dx(const void* x, const float* dy, void* dx,
                    const float* sums, const float* stats,
                    const float* scale, Geometry g, float count,
                    int stat_grads, cudaStream_t stream) {
  if (!takes(g) || (stat_grads && sums == nullptr)) return cudaErrorInvalidValue;
  const dim3 grid(g.slices, g.tiles);
  return static_cast<int>(dispatch(g, [&](auto cfg) {
    using K = decltype(cfg);
    using T = typename K::type;
    bn_dx_kernel<T, K::vec, K::dense><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), dy, static_cast<T*>(dx), sums, stats,
        scale, g, count, stat_grads);
    return cudaGetLastError();
  }));
}

}  // extern "C"
