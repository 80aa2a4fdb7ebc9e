// Factorized-prior (entropy bottleneck) likelihood and its gradient,
// hand-written for Hopper.
//
// K3      lossyless_eb_likelihood      replaces the Pallas kernel
//         lossyless_tpu/coding/pallas_eb.py::eb_likelihood_fused (_kernel):
//         for each element z of a (batch, channels) tensor, run the
//         channel's chain  v <- softplus(M_l) v + b_l,
//         v <- v + tanh(f_l) tanh(v)  (all but the last layer) at z - 0.5
//         and at z + 0.5, then the sign trick
//         |sigmoid(s*upper) - sigmoid(s*lower)| with s = -sign(lower+upper),
//         floored at 1e-9; all in fp32.
// K3 bwd  lossyless_eb_likelihood_bwd  replaces the custom VJP's backward
//         (pallas_eb.py::_bwd, which differentiates the reference chain):
//         recomputes both chains in registers and applies the chain rule
//         (lower_bound's pass-through (lik >= 1e-9) | (g < 0), the sign
//         held constant, d|D| = +1 for D >= 0 and -1 below (JAX's
//         derivative of abs: 1 at 0), d softplus = sigmoid, d tanh =
//         1 - tanh^2), giving dz per element and the
//         gradients of every matrix, bias and factor summed over the batch
//         and both chains.
//
// Design. Both kernels read z, g and dz in the callers' (batch, channels)
// layout and the parameters where they lie (a table of pointers, in the
// order of pallas_eb.pack_weights: matrix, bias, factor of each layer;
// nothing is packed per call). A cluster of kSplit blocks owns a group
// of 32 channels and all their batch rows: lane c of every
// warp is channel c0 + c, so each warp reads and writes 128 contiguous
// bytes of a row, and the cluster's warps walk the rows. Each coefficient
// is transformed (softplus of a matrix entry, tanh of a factor) once a
// call: the cluster's threads split the group's coefficients, each block
// transforms its share into its shared-memory table, and after a cluster
// barrier copies the others' shares from their tables (distributed shared
// memory). For the filters the presets run, (3,3,3,3) and the default
// (3,3,3), the chain is a compile-time shape (`Fixed`): it unrolls fully,
// the thread keeps its channel's 58 (or 43) coefficients and, in the
// backward, its gradient sums and both chains' intermediates in
// registers. Any other tuple up to width 8 and 8 layers runs `Generic`:
// a loop over the layers, each unrolled to width 8 with run-time guards, the
// coefficients read from the table, the gradient sums kept in shared
// memory and the backward's intermediates in local memory. The wrapper's
// plan gives a block as many warps (at most kWarps) as leave every
// cluster of the call resident at once.
//
// The backward sums deterministically, with no atomics: each thread over
// its rows in order; a block over its warps in order; the cluster over its
// blocks in rank order, through distributed shared memory; then the sum
// is multiplied by sigmoid(M) or 1 - tanh(f)^2 and written into tensors
// shaped like the parameters.
//
// Bound on an H100 SXM at the training shape B=128, C=512, filters
// (3,3,3,3): the forward's ~15.7 MFLOP take 0.23 us at the 67 TFLOP/s
// fp32 peak, its 643 KB (z, the likelihoods, the parameters) 0.19 us at
// 3.35 TB/s; the backward's ~43 MFLOP 0.65 us. A call is latency-bound
// (the launch, two cluster barriers, chains of dependent transcendental
// functions): the design gives each call one launch, one pass over z and
// no intermediate in device memory.
//
// Interface: plain C, loaded with ctypes. A launcher runs on the given
// stream on the current device, does not synchronise and returns
// cudaGetLastError(). lossyless_eb_init raises the kernels' dynamic
// shared-memory limit; the wrapper calls it once per device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// A named namespace: the C interface below takes Args by value, and a type
// of an unnamed namespace would give those functions internal linkage.
namespace lossyless_eb {

constexpr int kChannels = 32;  // channels per block: one per lane
constexpr int kSplit = 8;      // blocks per cluster: they split the rows
constexpr int kWarps = 8;      // warps per block, at most
constexpr int kThreads = kChannels * kWarps;
constexpr int kMaxWidth = 8;   // widest filter
constexpr int kMaxLayers = 8;  // layers of the chain (filters + 1)
constexpr int kSlots = 3 * kMaxLayers;  // matrix, bias, factor per layer
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr float kBound = 1e-9f;

// The parameters (and their gradients) by slot 3 l + {0: matrix (C, out,
// in), 1: bias (C, out, 1), 2: factor (C, out, 1)}; width = (1,
// filters..., 1), padded with 1. grad[0] null: no parameter gradients.
struct Args {
  const float* param[kSlots];
  float* grad[kSlots];
  int n_layers;
  int width[kMaxLayers + 1];
};

__host__ __device__ constexpr int layer_coeffs(int d_in, int d_out,
                                               bool last) {
  return d_out * d_in + d_out + (last ? 0 : d_out);
}

// A chain whose filters are compile-time constants.
template <int... F>
__host__ __device__ constexpr int fixed_width(int l) {
  constexpr int w[] = {1, F..., 1};
  return w[l];
}

template <int... F>
constexpr int fixed_widest() {
  int m = 1;
  for (int l = 1; l <= static_cast<int>(sizeof...(F)); ++l)
    m = fixed_width<F...>(l) > m ? fixed_width<F...>(l) : m;
  return m;
}

// first coefficient of layer l, in pack_weights order
template <int... F>
__host__ __device__ constexpr int fixed_off(int l) {
  constexpr int L = sizeof...(F) + 1;
  int k = 0;
  for (int i = 0; i < l; ++i)
    k += layer_coeffs(fixed_width<F...>(i), fixed_width<F...>(i + 1),
                      i == L - 1);
  return k;
}

template <int... F>
struct Fixed {
  static constexpr bool kFixed = true;
  static constexpr int L = sizeof...(F) + 1;
  static constexpr int W = fixed_widest<F...>();
  static constexpr int K = fixed_off<F...>(L);
  __host__ __device__ static constexpr int width(int l) {
    return fixed_width<F...>(l);
  }
  __host__ __device__ static constexpr int off(int l) {
    return fixed_off<F...>(l);
  }
  __device__ explicit Fixed(const Args&) {}
};

// Any chain of at most kMaxLayers layers whose filters are at most
// kMaxWidth wide: a loop over the layers, each unrolled to kMaxWidth and
// guarded at run time.
struct Generic {
  static constexpr bool kFixed = false;
  static constexpr int L = kMaxLayers;
  static constexpr int W = kMaxWidth;
  int n;
  int w[kMaxLayers + 1];
  int o[kMaxLayers + 1];
  __device__ explicit Generic(const Args& a) : n(a.n_layers) {
#pragma unroll
    for (int l = 0; l <= kMaxLayers; ++l) w[l] = a.width[l];
    int k = 0;
#pragma unroll
    for (int l = 0; l <= kMaxLayers; ++l) {
      o[l] = k;
      if (l < kMaxLayers && l < n) k += layer_coeffs(w[l], w[l + 1], l == n - 1);
    }
  }
  __device__ int width(int l) const { return w[l]; }
  __device__ int off(int l) const { return o[l]; }
};

using F3333 = Fixed<3, 3, 3, 3>;
using F333 = Fixed<3, 3, 3>;
enum Design { kF3333 = 0, kF333 = 1, kGeneric = 2 };

// The thread's channel's transformed coefficients: in registers for a
// fixed chain, read from the table otherwise.
template <int K>
struct RegTable {
  float v[K];
  __device__ explicit RegTable(const float* table) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = table[k * kChannels];
  }
  __device__ float operator()(int k) const { return v[k]; }
};

struct SmemTable {
  const float* p;
  __device__ explicit SmemTable(const float* table) : p(table) {}
  __device__ float operator()(int k) const { return p[k * kChannels]; }
};

// The thread's gradient sums, one per coefficient: in registers for a
// fixed chain, in the thread's own shared-memory slots otherwise.
template <int K>
struct RegSums {
  float v[K];
  float* slot;
  __device__ explicit RegSums(float* s) : slot(s) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = 0.f;
  }
  __device__ void add(int k, float x) { v[k] += x; }
  __device__ void finish() {
#pragma unroll
    for (int k = 0; k < K; ++k) slot[k * kChannels] = v[k];
  }
};

struct SmemSums {
  float* slot;
  __device__ SmemSums(float* s, int K) : slot(s) {
    for (int k = 0; k < K; ++k) slot[k * kChannels] = 0.f;
  }
  __device__ void add(int k, float x) { slot[k * kChannels] += x; }
  __device__ void finish() {}
};

template <class D, bool = D::kFixed>
struct Storage {
  using Table = RegTable<D::K>;
  using Sums = RegSums<D::K>;
  __device__ static Sums sums(float* slot, int) { return Sums(slot); }
};
template <class D>
struct Storage<D, false> {
  using Table = SmemTable;
  using Sums = SmemSums;
  __device__ static Sums sums(float* slot, int K) { return Sums(slot, K); }
};

// Each layer's input and each tanh stage's tanh, for the backward.
template <class D>
struct Tape {
  float in[D::L][D::W];
  float th[D::L][D::W];
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Layer l of the chain (d_in -> d_out inputs, first coefficient o) on the
// state s; with kTape it records what the backward needs. For a fixed
// chain every argument is a compile-time constant once inlined.
template <bool kTape, class D, class T>
__device__ __forceinline__ void layer(const T& t, float (&s)[D::W],
                                      Tape<D>& tape, int l, int di, int dout,
                                      int o, bool last) {
  const int ob = o + dout * di;  // bias, then factor
  float u[D::W];
#pragma unroll
  for (int j = 0; j < D::W; ++j) {
    if (j < dout) {
      float acc = t(ob + j);
#pragma unroll
      for (int k = 0; k < D::W; ++k)
        if (k < di) acc = fmaf(t(o + j * di + k), s[k], acc);
      u[j] = acc;
    }
  }
  if (kTape) {
#pragma unroll
    for (int k = 0; k < D::W; ++k)
      if (k < di) tape.in[l][k] = s[k];
  }
#pragma unroll
  for (int j = 0; j < D::W; ++j) {
    if (j < dout) {
      if (last) {
        s[j] = u[j];
      } else {
        const float th = tanhf(u[j]);
        if (kTape) tape.th[l][j] = th;
        s[j] = fmaf(t(ob + dout + j), th, u[j]);
      }
    }
  }
}

// Back through layer l from g = d loss / d its output: adds each
// coefficient's gradient (with respect to softplus(M), b and tanh(f)) to
// `sums` and leaves d loss / d its input in g.
template <class D, class T, class S>
__device__ __forceinline__ void layer_grad(const T& t, float (&g)[D::W],
                                           const Tape<D>& tape, S& sums,
                                           int l, int di, int dout, int o,
                                           bool last) {
  const int ob = o + dout * di;
  float gu[D::W];
#pragma unroll
  for (int j = 0; j < D::W; ++j) {
    if (j < dout) {
      if (last) {
        gu[j] = g[j];
      } else {
        const float th = tape.th[l][j];
        sums.add(ob + dout + j, g[j] * th);
        gu[j] = fmaf(g[j] * t(ob + dout + j), 1.f - th * th, g[j]);
      }
    }
  }
  float gi[D::W];
#pragma unroll
  for (int k = 0; k < D::W; ++k) gi[k] = 0.f;
#pragma unroll
  for (int j = 0; j < D::W; ++j) {
    if (j < dout) {
      sums.add(ob + j, gu[j]);
#pragma unroll
      for (int k = 0; k < D::W; ++k) {
        if (k < di) {
          sums.add(o + j * di + k, gu[j] * tape.in[l][k]);
          gi[k] = fmaf(t(o + j * di + k), gu[j], gi[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < D::W; ++k)
    if (k < di) g[k] = gi[k];
}

// A fixed chain's layers from l on, by template recursion: the widths and
// offsets are constant expressions, so the table, the sums and the tape
// are indexed by constants and stay in registers.
template <int l, bool kTape, class D, class T>
__device__ __forceinline__ void fixed_layers(const T& t, float (&s)[D::W],
                                             Tape<D>& tape) {
  if constexpr (l < D::L) {
    constexpr int di = D::width(l), dout = D::width(l + 1), o = D::off(l);
    layer<kTape, D>(t, s, tape, l, di, dout, o, l == D::L - 1);
    fixed_layers<l + 1, kTape, D>(t, s, tape);
  }
}

template <int l, class D, class T, class S>
__device__ __forceinline__ void fixed_layers_grad(const T& t,
                                                  float (&g)[D::W],
                                                  const Tape<D>& tape,
                                                  S& sums) {
  if constexpr (l >= 0) {
    constexpr int di = D::width(l), dout = D::width(l + 1), o = D::off(l);
    layer_grad<D>(t, g, tape, sums, l, di, dout, o, l == D::L - 1);
    fixed_layers_grad<l - 1, D>(t, g, tape, sums);
  }
}

// The chain at v; with kTape it records what the backward needs.
template <bool kTape, class D, class T>
__device__ __forceinline__ float chain(const D& d, const T& t, float v,
                                       Tape<D>& tape) {
  float s[D::W];
  s[0] = v;
  if constexpr (D::kFixed) {
    fixed_layers<0, kTape, D>(t, s, tape);
  } else {
#pragma unroll 1
    for (int l = 0; l < d.n; ++l)
      layer<kTape, D>(t, s, tape, l, d.width(l), d.width(l + 1), d.off(l),
                      l == d.n - 1);
  }
  return s[0];
}

// Back through the chain from g0 = d loss / d chain(v); returns
// d loss / d v.
template <class D, class T, class S>
__device__ __forceinline__ float chain_grad(const D& d, const T& t,
                                            const Tape<D>& tape, float g0,
                                            S& sums) {
  float g[D::W];
  g[0] = g0;
  if constexpr (D::kFixed) {
    fixed_layers_grad<D::L - 1, D>(t, g, tape, sums);
  } else {
#pragma unroll 1
    for (int l = d.n - 1; l >= 0; --l)
      layer_grad<D>(t, g, tape, sums, l, d.width(l), d.width(l + 1),
                    d.off(l), l == d.n - 1);
  }
  return g[0];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Where coefficient k of a channel lives: its parameter (and gradient)
// tensor, its kind (0 matrix, 1 bias, 2 factor), its count S a channel and
// its index among them. Slots are walked with constant indices and picked
// by selects, so the pointers stay in parameter space.
struct Coef {
  const float* p;
  float* grad;
  int kind, S, kk;
};

__device__ __forceinline__ Coef coef_of(const Args& a, int k) {
  Coef r{a.param[0], a.grad[0], 0, 1, 0};
  int base = 0;
#pragma unroll
  for (int q = 0; q < kSlots - 1; ++q) {
    if (q < 3 * a.n_layers - 1) {
      const int l = q / 3, kind = q % 3;
      const int S = kind == 0 ? a.width[l + 1] * a.width[l] : a.width[l + 1];
      if (k >= base && k < base + S) r = Coef{a.param[q], a.grad[q], kind, S,
                                              k - base};
      base += S;
    }
  }
  return r;
}

// Table position pos = k * kChannels + c (coefficient k of channel c0 + c)
// belongs to block (pos / blockDim.x) % kSplit of the cluster.
constexpr int kGather = 8;  // remote loads a thread keeps in flight

// Fills `table` (K, kChannels) with the transformed coefficients of the
// cluster's channels: each block transforms the positions it owns (at the
// training shape one a thread), then, after a cluster barrier, copies the
// others' from their owners' tables. Ends with the copies done, not
// fenced for the block.
__device__ __forceinline__ void build_table(const Args& a, int c0, int n_ch,
                                            int K, float* table,
                                            cg::cluster_group& cl) {
  const unsigned rank = cl.block_rank();
  const int T = blockDim.x, total = K * kChannels;
  for (int pos = rank * T + threadIdx.x; pos < total; pos += kSplit * T) {
    const int c = pos % kChannels;
    if (c < n_ch) {
      const Coef e = coef_of(a, pos / kChannels);
      const float x = e.p[static_cast<int64_t>(c0 + c) * e.S + e.kk];
      table[pos] = e.kind == 0 ? softplus(x) : e.kind == 2 ? tanhf(x) : x;
    }
  }
  cl.sync();
  for (int first = threadIdx.x; first < total; first += kGather * T) {
    const int row = first / T;
    float v[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int pos = first + u * T;
      const unsigned owner = (row + u) % kSplit;
      v[u] = pos < total && owner != rank
                 ? cl.map_shared_rank(table, owner)[pos] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int pos = first + u * T;
      if (pos < total && (row + u) % kSplit != rank) table[pos] = v[u];
    }
  }
}

template <class D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
    eb_likelihood_kernel(const float* __restrict__ z, float* __restrict__ out,
                         int B, int C, int K, const Args a) {
  extern __shared__ float table[];
  cg::cluster_group cl = cg::this_cluster();
  const int c0 = (blockIdx.x / kSplit) * kChannels;
  const int n_ch = min(kChannels, C - c0);
  const int lane = threadIdx.x % kChannels;
  const int warps = blockDim.x / kChannels;
  const int64_t r0 = cl.block_rank() * warps + threadIdx.x / kChannels;
  const int64_t step = kSplit * warps;
  // the first row's z is read while the table is built, each next row's
  // while a row is computed
  float v_next = lane < n_ch && r0 < B ? z[r0 * C + c0 + lane] : 0.f;
  build_table(a, c0, n_ch, K, table, cl);
  cluster_arrive();  // this block reads no other table from here on
  __syncthreads();

  if (lane < n_ch) {
    const D d(a);
    const typename Storage<D>::Table t(table + lane);
    Tape<D> none;
    for (int64_t r = r0; r < B; r += step) {
      const int64_t i = r * C + c0 + lane;
      const float v = v_next;
      if (r + step < B) v_next = z[i + step * C];
      const float lower = chain<false>(d, t, v - 0.5f, none);
      const float upper = chain<false>(d, t, v + 0.5f, none);
      const float sum = lower + upper;
      const float s = sum > 0.f ? -1.f : (sum < 0.f ? 1.f : 0.f);
      const float lik = fabsf(sigmoid(s * upper) - sigmoid(s * lower));
      out[i] = fmaxf(lik, kBound);
    }
  }
  cluster_wait();  // no block leaves while another may read its table
}

template <class D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
    eb_likelihood_bwd_kernel(const float* __restrict__ z,
                             const float* __restrict__ g,
                             float* __restrict__ dz, int B, int C, int K,
                             const Args a) {
  extern __shared__ float smem[];
  float* table = smem;                  // (K, kChannels)
  float* part = smem + K * kChannels;   // (warps, K, kChannels) sums
  cg::cluster_group cl = cg::this_cluster();
  const int c0 = (blockIdx.x / kSplit) * kChannels;
  const int n_ch = min(kChannels, C - c0);
  const int lane = threadIdx.x % kChannels, warp = threadIdx.x / kChannels;
  const int warps = blockDim.x / kChannels;
  const int64_t r0 = cl.block_rank() * warps + warp;
  const int64_t step = kSplit * warps;
  // the first row's z and g are read while the table is built, each next
  // row's while a row is computed
  const bool first = lane < n_ch && r0 < B;
  float v_next = first ? z[r0 * C + c0 + lane] : 0.f;
  float g_next = first ? g[r0 * C + c0 + lane] : 0.f;
  build_table(a, c0, n_ch, K, table, cl);
  __syncthreads();

  typename Storage<D>::Sums sums =
      Storage<D>::sums(part + warp * K * kChannels + lane, K);
  if (lane < n_ch) {
    const D d(a);
    const typename Storage<D>::Table t(table + lane);
    for (int64_t r = r0; r < B; r += step) {
      const int64_t i = r * C + c0 + lane;
      const float v = v_next, go = g_next;
      if (r + step < B) {
        v_next = z[i + step * C];
        g_next = g[i + step * C];
      }
      Tape<D> tl, tu;
      const float lower = chain<true>(d, t, v - 0.5f, tl);
      const float upper = chain<true>(d, t, v + 0.5f, tu);
      const float sum = lower + upper;
      const float s = sum > 0.f ? -1.f : (sum < 0.f ? 1.f : 0.f);
      const float pu = sigmoid(s * upper), pl = sigmoid(s * lower);
      const float delta = pu - pl;
      // lower_bound's pass-through, then d|delta| (+1 at 0, as JAX's)
      const float gb = (fabsf(delta) >= kBound || go < 0.f) ? go : 0.f;
      const float gd = delta >= 0.f ? gb : -gb;
      const float gu = gd * (pu * (1.f - pu)) * s;
      const float gl = -gd * (pl * (1.f - pl)) * s;
      const float dl = chain_grad(d, t, tl, gl, sums);
      const float du = chain_grad(d, t, tu, gu, sums);
      if (dz) dz[i] = dl + du;
    }
  }
  sums.finish();
  __syncthreads();

  const bool params = a.grad[0] != nullptr;
  if (params) {  // the block's sums, over its warps in order
    for (int e = threadIdx.x; e < K * kChannels; e += blockDim.x) {
      float x[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        x[w] = w < warps ? part[w * K * kChannels + e] : 0.f;
      float acc = x[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        if (w < warps) acc += x[w];
      part[e] = acc;
    }
  }
  cl.sync();
  if (params) {  // the cluster's, over its blocks in rank order
    const int T = blockDim.x, total = K * kChannels;
    for (int pos = cl.block_rank() * T + threadIdx.x; pos < total;
         pos += kSplit * T) {
      const int c = pos % kChannels;
      if (c < n_ch) {
        float x[kSplit];
#pragma unroll
        for (int b = 0; b < kSplit; ++b)
          x[b] = cl.map_shared_rank(part, b)[pos];
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < kSplit; ++b) acc += x[b];
        const Coef e = coef_of(a, pos / kChannels);
        const int64_t at = static_cast<int64_t>(c0 + c) * e.S + e.kk;
        // sigmoid(M) = 1 - exp(-softplus(M)), from the table
        if (e.kind == 0) acc *= -expm1f(-table[pos]);
        if (e.kind == 2) acc *= 1.f - table[pos] * table[pos];
        e.grad[at] = acc;
      }
    }
  }
  cl.sync();  // no block leaves while another may read its sums
}

// host side: what a design can run, and the shared memory it needs

// coefficients a channel (K), or -1 where the widths are not (1,
// filters..., 1) with filters 1..kMaxWidth wide, padded with 1
int coeffs_of(const Args& a) {
  if (a.n_layers < 1 || a.n_layers > kMaxLayers) return -1;
  for (int l = 0; l <= kMaxLayers; ++l) {
    const int w = a.width[l];
    if (w < 1 || w > kMaxWidth || (l > a.n_layers && w != 1)) return -1;
  }
  if (a.width[0] != 1 || a.width[a.n_layers] != 1) return -1;
  int k = 0;
  for (int l = 0; l < a.n_layers; ++l)
    k += layer_coeffs(a.width[l], a.width[l + 1], l == a.n_layers - 1);
  return k;
}

template <class D>
bool fixed_matches(const Args& a) {
  if (a.n_layers != D::L) return false;
  for (int l = 0; l <= D::L; ++l)
    if (a.width[l] != D::width(l)) return false;
  return true;
}

bool runs(int design, const Args& a) {
  switch (design) {
    case kF3333: return fixed_matches<F3333>(a);
    case kF333: return fixed_matches<F333>(a);
    case kGeneric: return true;
    default: return false;
  }
}

// K, or -1 where the call is not one the kernels take
int check(int B, int C, int design, int threads, const Args& a) {
  const int K = coeffs_of(a);
  if (K < 0 || B < 1 || C < 1 || !runs(design, a)) return -1;
  if (threads < kChannels || threads > kThreads || threads % kChannels)
    return -1;
  for (int q = 0; q < 3 * a.n_layers - 1; ++q)
    if (a.param[q] == nullptr) return -1;
  return K;
}

size_t table_bytes(int K) { return sizeof(float) * K * kChannels; }

template <class D>
void launch_fwd(const float* z, float* out, int B, int C, int K, int threads,
                size_t smem, const Args& a, cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(C) + kChannels - 1) /
                         kChannels * kSplit;
  eb_likelihood_kernel<D><<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      z, out, B, C, K, a);
}

template <class D>
void launch_bwd(const float* z, const float* g, float* dz, int B, int C,
                int K, int threads, size_t smem, const Args& a,
                cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(C) + kChannels - 1) /
                         kChannels * kSplit;
  eb_likelihood_bwd_kernel<D><<<static_cast<unsigned>(blocks), threads, smem, s>>>(z, g, dz, B, C,
                                                            K, a);
}

template <class D>
cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      eb_likelihood_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(eb_likelihood_bwd_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace lossyless_eb

using namespace lossyless_eb;

extern "C" {

// The geometry the wrapper's plan mirrors: channels a block, blocks a
// cluster, warps a block at most, widest filter, most layers, shared
// memory a block may use.
void lossyless_eb_geometry(int* out) {
  out[0] = kChannels;
  out[1] = kSplit;
  out[2] = kWarps;
  out[3] = kMaxWidth;
  out[4] = kMaxLayers;
  out[5] = kMaxSmem;
}

// Lets every kernel use up to kMaxSmem of dynamic shared memory on the
// current device. Once per device, before the first launch.
int lossyless_eb_init(void) {
  cudaError_t e = allow_smem<F3333>();
  if (e == cudaSuccess) e = allow_smem<F333>();
  if (e == cudaSuccess) e = allow_smem<Generic>();
  return static_cast<int>(e);
}

// How many clusters of the given kernel (design, backward or not, threads
// a block, dynamic shared memory) the current device holds at once; < 0 on
// a CUDA error.
int lossyless_eb_resident_clusters(int design, int bwd, int threads,
                                   size_t smem) {
  const void* fns[2][3] = {
      {reinterpret_cast<const void*>(eb_likelihood_kernel<F3333>),
       reinterpret_cast<const void*>(eb_likelihood_kernel<F333>),
       reinterpret_cast<const void*>(eb_likelihood_kernel<Generic>)},
      {reinterpret_cast<const void*>(eb_likelihood_bwd_kernel<F3333>),
       reinterpret_cast<const void*>(eb_likelihood_bwd_kernel<F333>),
       reinterpret_cast<const void*>(eb_likelihood_bwd_kernel<Generic>)}};
  if (design < kF3333 || design > kGeneric) return -1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kSplit);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, fns[bwd ? 1 : 0][design], &config);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// K3. z (B, C) fp32 contiguous -> out (B, C); `threads` a multiple of 32
// up to kThreads, smem = K * kChannels floats.
int lossyless_eb_likelihood(const void* z, void* out, int B, int C,
                            int design, int threads, size_t smem, Args a,
                            void* stream) {
  const int K = check(B, C, design, threads, a);
  if (K < 0 || smem != table_bytes(K))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* zf = static_cast<const float*>(z);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case kF3333: launch_fwd<F3333>(zf, of, B, C, K, threads, smem, a, s); break;
    case kF333: launch_fwd<F333>(zf, of, B, C, K, threads, smem, a, s); break;
    default: launch_fwd<Generic>(zf, of, B, C, K, threads, smem, a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3's backward. z, g (B, C) fp32 contiguous -> dz (B, C) (null: none)
// and, where a.grad[0] is not null, every a.grad[q] shaped like
// a.param[q]; smem = (1 + threads / 32) * K * kChannels floats.
int lossyless_eb_likelihood_bwd(const void* z, const void* g, void* dz,
                                int B, int C, int design, int threads,
                                size_t smem, Args a, void* stream) {
  const int K = check(B, C, design, threads, a);
  if (K < 0 || smem != table_bytes(K) * (1 + threads / kChannels) ||
      smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.grad[0] != nullptr)
    for (int q = 0; q < 3 * a.n_layers - 1; ++q)
      if (a.grad[q] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto* zf = static_cast<const float*>(z);
  const auto* gf = static_cast<const float*>(g);
  auto* df = static_cast<float*>(dz);
  auto s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case kF3333:
      launch_bwd<F3333>(zf, gf, df, B, C, K, threads, smem, a, s);
      break;
    case kF333:
      launch_bwd<F333>(zf, gf, df, B, C, K, threads, smem, a, s);
      break;
    default: launch_bwd<Generic>(zf, gf, df, B, C, K, threads, smem, a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
