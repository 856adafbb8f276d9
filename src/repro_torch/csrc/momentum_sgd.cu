// B3: fused heavy-ball update (paper eq. 4, velocity form).
//
// Replaces: momentum_sgd_pallas, src/repro/kernels/momentum_sgd.py:45
// (pallas_call at :63, body _momentum_kernel at :35).
//
// Computes, elementwise over every leaf of a parameter dict, with runtime
// f32 eta and theta:
//   v' = theta * v - eta * g ;  y' = y + v'
// in f32, each result stored in the leaf's dtype: f32, or bf16 (the
// Pallas body widens its operands with astype(f32) and narrows at the
// store, so y' adds the unrounded f32 v'). The bf16 entries widen every
// load to f32 exactly (the 16 bits move to the top of the word) and store
// with round-to-nearest-even, NaN to 0x7fc0: XLA's convert and PyTorch's
// to(bfloat16) round the same way.
//
// Four entries share the kernel body: momentum_sgd and momentum_sgd_lanes
// on f32 leaves, momentum_sgd_bf16 and momentum_sgd_lanes_bf16 on bf16
// leaves (one table holds one dtype; the wrapper calls one entry a dtype
// group). The scalar entries take eta as a host float (a kernel
// parameter). The lane entries take a device f32 eta [m], one per client,
// for the async engine's staleness-decayed step (the reference vmaps the
// Pallas kernel's runtime scalar block over the clients,
// src/repro/core/async_gossip.py:326-340): every leaf is [m, ...], and
// value i of a leaf belongs to client i / (size / m). A CUDA graph replays
// a host eta as it was captured; a device eta is read at replay, so a
// captured event follows each event's decay. The client of a value is a
// 32-bit division where the leaf fits (one a value; the 2NN's b3 has 10
// values a client, so a block spans many clients), the eta a cached
// 4-byte load; the rounding is the scalar entry's.
//
// Bound on the H100: bytes. Three reads and two writes of every value:
// 20 B a value in f32, 10 B in bf16. One local step of the 2NN main path
// (16 clients x 199 210 params, f32) moves ~64 MB, ~19 us at 3.35 TB/s;
// one of SmolLM-135M at m 8 in bf16 (8 x 134 515 008 values) ~10.8 GB,
// ~3.2 ms.
//
// Design: ONE launch per step over all leaves of a dtype. The C entry
// fills a leaf table (five pointers and a size per leaf, at most
// kMaxLeaves; more leaves take further launches) and passes it BY VALUE as
// a kernel parameter (~3.3 KB, under the 4 KB limit), so no host-to-device
// copy precedes the launch. Every leaf is cut into chunks of kChunk
// values; the entry builds the chunk prefix, and block b serves the leaf l
// with chunk_start[l] <= b < chunk_start[l + 1] (a binary search over the
// prefix, uniform across the block; an empty leaf owns no block). A leaf
// whose five pointers are all aligned to four values (16 bytes in f32, 8
// in bf16) moves four values a load (all loads of a thread issued before
// its stores, for memory parallelism) with a scalar tail; any other leaf
// takes a scalar loop in the same kernel. Indices are int64 throughout:
// SmolLM-135M's stacked MLP weight is 26.5 M values a client, 212 M at m 8.
// Each multiply and add is a separate _rn intrinsic, so nvcc cannot
// contract theta*v - eta*g into an FMA and the result is bitwise equal to
// the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * 4 * kUnroll;   // values a block serves
constexpr int kMaxLeaves = 64;

// A bf16 value as its 16 bits.
struct bf16 {
  uint16_t bits;
};

template <typename T>
struct LeafTable {
  const T* y[kMaxLeaves];
  const T* v[kMaxLeaves];
  const T* g[kMaxLeaves];
  T* y_out[kMaxLeaves];
  T* v_out[kMaxLeaves];
  int64_t size[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];
  int n_leaves;
};
static_assert(sizeof(LeafTable<float>) + 2 * sizeof(float) +
                      sizeof(void*) + sizeof(int64_t) <= 4096,
              "kernel parameters must stay under 4 KB");
static_assert(sizeof(LeafTable<bf16>) == sizeof(LeafTable<float>),
              "one table layout for both dtypes");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) {
  return __uint_as_float(static_cast<uint32_t>(x.bits) << 16);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
// Round to nearest, ties to even; every NaN becomes the quiet 0x7fc0.
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return bf16{0x7fc0};
  return bf16{static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}

// Four consecutive values, aligned to four, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const uint32_t a = narrow<bf16>(x.x).bits, b = narrow<bf16>(x.y).bits;
  const uint32_t c = narrow<bf16>(x.z).bits, d = narrow<bf16>(x.w).bits;
  *reinterpret_cast<uint2*>(p) = make_uint2(a | (b << 16), c | (d << 16));
}

__device__ __forceinline__ float step_v(float v, float g, float eta,
                                        float theta) {
  return __fsub_rn(__fmul_rn(theta, v), __fmul_rn(eta, g));
}

__device__ __forceinline__ float4 step_v4(float4 v, float4 g, float eta,
                                          float theta) {
  return make_float4(step_v(v.x, g.x, eta, theta),
                     step_v(v.y, g.y, eta, theta),
                     step_v(v.z, g.z, eta, theta),
                     step_v(v.w, g.w, eta, theta));
}

__device__ __forceinline__ float4 step_v4(float4 v, float4 g, float4 eta,
                                          float theta) {
  return make_float4(step_v(v.x, g.x, eta.x, theta),
                     step_v(v.y, g.y, eta.y, theta),
                     step_v(v.z, g.z, eta.z, theta),
                     step_v(v.w, g.w, eta.w, theta));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The eta of value i of a leaf with `per` values a client: the lane
// entry's etas[i / per] (32-bit division when the leaf fits).
struct LaneEta {
  const float* __restrict__ etas;
  int64_t per;
  bool narrow;
  __device__ __forceinline__ float operator()(int64_t i) const {
    const int64_t c = narrow ? static_cast<int64_t>(
                                   static_cast<uint32_t>(i) /
                                   static_cast<uint32_t>(per))
                             : i / per;
    return __ldg(etas + c);
  }
};

// The body of every kernel. LANES = false: one eta for every value;
// true: etas [m] by client. T: the leaves' dtype (float or bf16).
template <bool LANES, typename T>
__device__ __forceinline__ void step_leaves(const LeafTable<T>& t, float eta,
                                            const float* __restrict__ etas,
                                            int64_t m, float theta) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;   // largest l with chunk_start[l] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int l = lo;
  const T* __restrict__ y = t.y[l];
  const T* __restrict__ v = t.v[l];
  const T* __restrict__ g = t.g[l];
  T* __restrict__ y_out = t.y_out[l];
  T* __restrict__ v_out = t.v_out[l];
  const int64_t begin = static_cast<int64_t>(b - t.chunk_start[l]) * kChunk;
  const int64_t end =
      begin + kChunk < t.size[l] ? begin + kChunk : t.size[l];
  const uintptr_t any = reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(y_out) |
                        reinterpret_cast<uintptr_t>(v_out);
  LaneEta lane{etas, 1, true};
  if constexpr (LANES) {
    lane.per = t.size[l] / m;
    lane.narrow = t.size[l] <= 0xffffffffLL;
  }
  int64_t scalar_from = begin;
  if ((any & (4 * sizeof(T) - 1)) == 0) {
    const int64_t vend = begin + ((end - begin) & ~int64_t{3});
    float4 yv[kUnroll], vv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = begin + 4 * (threadIdx.x + u * kThreads);
      if (i < vend) {
        yv[u] = load4(y + i);
        vv[u] = load4(v + i);
        gv[u] = load4(g + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = begin + 4 * (threadIdx.x + u * kThreads);
      if (i < vend) {
        float4 vn;
        if constexpr (LANES) {
          vn = step_v4(vv[u], gv[u],
                       make_float4(lane(i), lane(i + 1), lane(i + 2),
                                   lane(i + 3)),
                       theta);
        } else {
          vn = step_v4(vv[u], gv[u], eta, theta);
        }
        store4(v_out + i, vn);
        store4(y_out + i, add4(yv[u], vn));
      }
    }
    scalar_from = vend;
  }
  for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    float e = eta;
    if constexpr (LANES) e = lane(i);
    const float vn = step_v(widen(v[i]), widen(g[i]), e, theta);
    v_out[i] = narrow<T>(vn);
    y_out[i] = narrow<T>(__fadd_rn(widen(y[i]), vn));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
momentum_sgd_kernel(const LeafTable<T> t, float eta, float theta) {
  step_leaves<false, T>(t, eta, nullptr, 1, theta);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
momentum_sgd_lanes_kernel(const LeafTable<T> t,
                          const float* __restrict__ etas, int64_t m,
                          float theta) {
  step_leaves<true, T>(t, 0.0f, etas, m, theta);
}

// Every entry: the leaf tables, one launch per kMaxLeaves leaves. With
// LANES every size must be a multiple of m >= 1 and etas non-null.
template <bool LANES, typename T>
int launch_steps(const uint64_t* ptrs, const int64_t* sizes, int n_leaves,
                 float eta, const float* etas, int64_t m, float theta,
                 void* stream, int* launches) {
  *launches = 0;
  if (n_leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (LANES && (m < 1 || etas == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    const int n = n_leaves - first < kMaxLeaves ? n_leaves - first
                                                : kMaxLeaves;
    LeafTable<T> t;
    int64_t blocks = 0;
    for (int j = 0; j < n; ++j) {
      const uint64_t* p = ptrs + 5 * (first + j);
      const int64_t size = sizes[first + j];
      if (size < 0 || (LANES && size % m != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      t.y[j] = reinterpret_cast<const T*>(p[0]);
      t.v[j] = reinterpret_cast<const T*>(p[1]);
      t.g[j] = reinterpret_cast<const T*>(p[2]);
      t.y_out[j] = reinterpret_cast<T*>(p[3]);
      t.v_out[j] = reinterpret_cast<T*>(p[4]);
      t.size[j] = size;
      t.chunk_start[j] = static_cast<int>(blocks);
      blocks += (size + kChunk - 1) / kChunk;
    }
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    t.chunk_start[n] = static_cast<int>(blocks);
    t.n_leaves = n;
    if (blocks == 0) continue;
    const unsigned grid = static_cast<unsigned>(blocks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (LANES) {
      momentum_sgd_lanes_kernel<T><<<grid, kThreads, 0, s>>>(t, etas, m,
                                                            theta);
    } else {
      momentum_sgd_kernel<T><<<grid, kThreads, 0, s>>>(t, eta, theta);
    }
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

}  // namespace

// One heavy-ball step over n_leaves f32 leaves. ptrs: host array
// [n_leaves][5] of device pointers (y, v, g, y_out, v_out); sizes: host
// int64 [n_leaves], each >= 0 (an empty leaf is skipped). One launch per
// kMaxLeaves leaves; *launches gets the number made. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a bad table).
extern "C" int momentum_sgd(const uint64_t* ptrs, const int64_t* sizes,
                            int n_leaves, float eta, float theta,
                            void* stream, int* launches) {
  return launch_steps<false, float>(ptrs, sizes, n_leaves, eta, nullptr, 1,
                                    theta, stream, launches);
}

// The same step on bf16 leaves (every pointer of the table bf16).
extern "C" int momentum_sgd_bf16(const uint64_t* ptrs, const int64_t* sizes,
                                 int n_leaves, float eta, float theta,
                                 void* stream, int* launches) {
  return launch_steps<false, bf16>(ptrs, sizes, n_leaves, eta, nullptr, 1,
                                   theta, stream, launches);
}

// The same step with a device f32 eta [m]: every leaf is [m, ...] (its
// size a multiple of m), and client c's values step with eta[c]. Returns
// cudaErrorInvalidValue for m < 1, a null eta or a size that m does not
// divide, as well as for a bad table.
extern "C" int momentum_sgd_lanes(const uint64_t* ptrs, const int64_t* sizes,
                                  int n_leaves, const void* eta, int64_t m,
                                  float theta, void* stream,
                                  int* launches) {
  return launch_steps<true, float>(ptrs, sizes, n_leaves, 0.0f,
                                   static_cast<const float*>(eta), m, theta,
                                   stream, launches);
}

// The lane entry on bf16 leaves (eta stays f32).
extern "C" int momentum_sgd_lanes_bf16(const uint64_t* ptrs,
                                       const int64_t* sizes, int n_leaves,
                                       const void* eta, int64_t m,
                                       float theta, void* stream,
                                       int* launches) {
  return launch_steps<true, bf16>(ptrs, sizes, n_leaves, 0.0f,
                                  static_cast<const float*>(eta), m, theta,
                                  stream, launches);
}
