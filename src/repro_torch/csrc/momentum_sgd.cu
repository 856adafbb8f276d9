// B3: fused heavy-ball update (paper eq. 4, velocity form).
//
// Replaces: momentum_sgd_pallas, src/repro/kernels/momentum_sgd.py:45
// (pallas_call at :63, body _momentum_kernel at :35).
//
// Computes, elementwise over every leaf of a parameter dict, with runtime
// f32 eta and theta:
//   v' = theta * v - eta * g ;  y' = y + v'
//
// Bound on the H100: bytes. Three reads and two writes of every value;
// for one local step of the 2NN main path (16 clients x 199 210 params)
// ~64 MB, ~19 us at 3.35 TB/s, four steps a round.
//
// Design: ONE launch per step over all leaves. The C entry fills a leaf
// table (five pointers and a size per leaf, at most kMaxLeaves; more
// leaves take further launches) and passes it BY VALUE as a kernel
// parameter (~3.3 KB, under the 4 KB limit), so no host-to-device copy
// precedes the launch. Every leaf is cut into chunks of kChunk values; the
// entry builds the chunk prefix, and block b serves the leaf l with
// chunk_start[l] <= b < chunk_start[l + 1] (a binary search over the
// prefix, uniform across the block; an empty leaf owns no block). A leaf
// whose five pointers are all 16-byte aligned moves as float4 (all loads
// of a thread issued before its stores, for memory parallelism) with a
// scalar tail; any other leaf takes a scalar loop in the same kernel. Each multiply and add is a separate _rn intrinsic, so
// nvcc cannot contract theta*v - eta*g into an FMA and the result is
// bitwise equal to the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * 4 * kUnroll;   // values a block serves
constexpr int kMaxLeaves = 64;

struct LeafTable {
  const float* y[kMaxLeaves];
  const float* v[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* y_out[kMaxLeaves];
  float* v_out[kMaxLeaves];
  int64_t size[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];
  int n_leaves;
};
static_assert(sizeof(LeafTable) + 2 * sizeof(float) <= 4096,
              "kernel parameters must stay under 4 KB");

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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
momentum_sgd_kernel(const LeafTable t, float eta, float theta) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;   // largest l with chunk_start[l] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int l = lo;
  const float* __restrict__ y = t.y[l];
  const float* __restrict__ v = t.v[l];
  const float* __restrict__ g = t.g[l];
  float* __restrict__ y_out = t.y_out[l];
  float* __restrict__ v_out = t.v_out[l];
  const int64_t begin = static_cast<int64_t>(b - t.chunk_start[l]) * kChunk;
  const int64_t end =
      begin + kChunk < t.size[l] ? begin + kChunk : t.size[l];
  const uintptr_t any = reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(y_out) |
                        reinterpret_cast<uintptr_t>(v_out);
  int64_t scalar_from = begin;
  if ((any & 15) == 0) {
    const int64_t vend = begin + ((end - begin) & ~int64_t{3});
    float4 yv[kUnroll], vv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = begin + 4 * (threadIdx.x + u * kThreads);
      if (i < vend) {
        yv[u] = __ldg(reinterpret_cast<const float4*>(y + i));
        vv[u] = __ldg(reinterpret_cast<const float4*>(v + i));
        gv[u] = __ldg(reinterpret_cast<const float4*>(g + i));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = begin + 4 * (threadIdx.x + u * kThreads);
      if (i < vend) {
        const float4 vn = step_v4(vv[u], gv[u], eta, theta);
        *reinterpret_cast<float4*>(v_out + i) = vn;
        *reinterpret_cast<float4*>(y_out + i) = add4(yv[u], vn);
      }
    }
    scalar_from = vend;
  }
  for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    const float vn = step_v(v[i], g[i], eta, theta);
    v_out[i] = vn;
    y_out[i] = __fadd_rn(y[i], vn);
  }
}

}  // namespace

// One heavy-ball step over n_leaves leaves. ptrs: host array [n_leaves][5]
// of device pointers (y, v, g, y_out, v_out), f32; sizes: host int64
// [n_leaves], each >= 0 (an empty leaf is skipped). One launch per
// kMaxLeaves leaves; *launches gets the number made. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a bad table).
extern "C" int momentum_sgd(const uint64_t* ptrs, const int64_t* sizes,
                            int n_leaves, float eta, float theta,
                            void* stream, int* launches) {
  *launches = 0;
  if (n_leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    const int n = n_leaves - first < kMaxLeaves ? n_leaves - first
                                                : kMaxLeaves;
    LeafTable t;
    int64_t blocks = 0;
    for (int j = 0; j < n; ++j) {
      const uint64_t* p = ptrs + 5 * (first + j);
      const int64_t size = sizes[first + j];
      if (size < 0) return static_cast<int>(cudaErrorInvalidValue);
      t.y[j] = reinterpret_cast<const float*>(p[0]);
      t.v[j] = reinterpret_cast<const float*>(p[1]);
      t.g[j] = reinterpret_cast<const float*>(p[2]);
      t.y_out[j] = reinterpret_cast<float*>(p[3]);
      t.v_out[j] = reinterpret_cast<float*>(p[4]);
      t.size[j] = size;
      t.chunk_start[j] = static_cast<int>(blocks);
      blocks += (size + kChunk - 1) / kChunk;
    }
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    t.chunk_start[n] = static_cast<int>(blocks);
    t.n_leaves = n;
    if (blocks == 0) continue;
    momentum_sgd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(t, eta,
                                                               theta);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}
