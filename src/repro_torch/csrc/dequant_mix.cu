// The wire decoders: fused unpack + dequantize + weighted gossip apply.
//
// B2, dequant_mix_buffer — replaces dequant_mix_buffer_pallas,
//   src/repro/kernels/dequant_mix.py:100 (pallas_call at :115, body
//   _dequant_mix_buffer_kernel at :69).
// B5, dequant_mix_momentum_buffer — replaces
//   dequant_mix_momentum_buffer_pallas, src/repro/kernels/dequant_mix.py:163
//   (pallas_call at :183, body _dequant_mix_momentum_buffer_kernel at :131).
// B7, dequant_mix_plan — replaces dequant_mix_plan_pallas,
//   src/repro/kernels/dequant_mix.py:203 (pallas_call at :216, body
//   _dequant_mix_plan_kernel at :45).
// B8, dequant_mix_ring — replaces dequant_mix_pallas,
//   src/repro/kernels/dequant_mix.py:232 (pallas_call at :243, body
//   _dequant_mix_kernel at :27): the ring form over three stream pointers.
//
// B2 computes, for every client c and planar element (i, w):
//   out[c,i,w] = base[c,i,w]
//              + sum_k weight[c,k] * (field_i(words[src[k,c], w]) - 2^(b-1))
//                                   * sblk[src[k,c], w / 512]
// in f32, own stream first (src row 0 is the identity), then the plan
// steps in order — the accumulation order of the JAX kernel. B5 adds the
// round's deferred heavy-ball step (theta * v - eta * g) to the f32
// accumulator before the store. B7 is the per-tensor form over one
// client: out = x + sum_k weight[k] * (field_k - 2^(b-1)) * scale[k] over
// a [k, W] stream stack. B8 is the ring's k = 3 with the weights (w_self,
// w_nb, w_nb): own, then left, then right.
//
// Bound on the H100: bytes. At the 2NN main path (m = 16, per = 4,
// W = 51 712, K = 3) B2 reads the base and every client's words once
// (the gather form) and writes the output, ~30 MB, ~8.9 us at 3.35 TB/s;
// B5 also reads v and g, ~56 MB, ~16.8 us; B7 and B8 on one client's 2NN
// vector ([4, 50 176], k = 3) move 2.2 MB, ~0.66 us, far below a launch:
// what bounds them is the launch and the DRAM latency of their loads.
//
// Design: grid (word chunks, clients). B2 and B5 gather each neighbour's
// words and scales through the plan's src table themselves, so the
// [m, K, W] stream stack the JAX reference builds is never written. A B2/B5
// thread holds 4 consecutive word columns and their per x 4 accumulators
// in registers: one 16-byte load of base (B5: and of v and g) per planar
// row, one 16-byte load of the 4 words per stream, one 16-byte store per
// row; neighbouring threads hold neighbouring columns, so every access is
// coalesced (one source client per (block, k)). W is a multiple of 512, so
// rows stay 16-byte aligned and a thread's columns share one lane block,
// hence one scale per stream. src[k, c] and w[c, k] are uniform across a
// block: a thread reads them, and its streams' scales, for up to kStreams
// streams at a time before any word of those streams is decoded, so their
// word loads are in flight together (the ring's K = 3 is one group). B7
// keeps one thread per column. B8 is built for latency: one launch, its
// three streams as three pointers (no [3, W] stack, no weight tensor: the
// weights come by value), and a thread of 4 columns issues every load it
// needs — its per 16-byte rows of x, the three streams' 16-byte words and
// the three scales — before it decodes anything (load_now: the compiler
// would otherwise sink each stream's loads to its decode), so the whole job
// is one DRAM round trip. 4 columns a thread is W / 4 = 12 544 threads at
// the 2NN vector; blocks of kRingThreads = 64 make that 196 blocks, so every
// one of the 132 SMs holds one (blocks of 256 would leave 83 SMs idle). Each
// multiply and add is a separate _rn intrinsic, so nvcc cannot contract
// them into an FMA and the output is bitwise equal to the plain PyTorch
// version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;
constexpr int kCols = 4;      // word columns a B2/B5 thread decodes
constexpr int kStreams = 4;   // streams whose words a B2/B5 thread loads
                              // before decoding any of them
constexpr int kRingThreads = 64;  // B8's block: >= 132 blocks at W = 50 176

// acc[i] += wk * ((field_i(word) - 2^(b-1)) * s), one rounding per step.
template <int BITS>
__device__ __forceinline__ void accumulate(float (&acc)[32 / BITS],
                                           uint32_t word, float s,
                                           float wk) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int OFFSET = 1 << (BITS - 1);
#pragma unroll
  for (int i = 0; i < 32 / BITS; ++i) {
    const int field = static_cast<int>((word >> (BITS * i)) & MASK);
    const float deq = __fmul_rn(static_cast<float>(field - OFFSET), s);
    acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, deq));
  }
}

__device__ __forceinline__ void unpack4(float4 a, float (&out)[kCols]) {
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// Loads that stay in the order they are written. nvcc and ptxas otherwise
// sink each of B8's loads to just before its first use, so a stream's
// words are only asked for after the previous stream is decoded (a DRAM
// round trip per stream); volatile loads keep their order, so B8 issues
// its own stream's words last, and every load is in flight before the
// first decode. A host build reads plainly.
__device__ __forceinline__ float4 load_now(const float* p) {
#ifdef __CUDA_ARCH__
  float4 v;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
#else
  return *reinterpret_cast<const float4*>(p);
#endif
}

__device__ __forceinline__ uint4 load_now(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
#else
  return *reinterpret_cast<const uint4*>(p);
#endif
}

__device__ __forceinline__ float load_scalar_now(const float* p) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}

// The body of B2 (MOMENTUM = false) and B5 (MOMENTUM = true) for client
// c and word columns [w, w + 4).
template <int BITS, bool MOMENTUM>
__device__ __forceinline__ void mix_columns(
    const float* __restrict__ base, const uint32_t* __restrict__ words,
    const float* __restrict__ sblk, const float* __restrict__ weights,
    const int* __restrict__ src, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int m, int K,
    int W, float eta, float theta) {
  constexpr int PER = 32 / BITS;
  const int c = blockIdx.y;
  const int w = kCols * (blockIdx.x * kThreads + threadIdx.x);
  if (w >= W) return;
  const size_t at = static_cast<size_t>(c) * PER * W + w;
  const int n_blocks = W / kLaneBlock;
  const int blk = w / kLaneBlock;
  float acc[kCols][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float b[kCols];
    unpack4(*reinterpret_cast<const float4*>(base + at
                                             + static_cast<size_t>(i) * W),
            b);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j][i] = b[j];
  }
  for (int k0 = 0; k0 < K; k0 += kStreams) {
    uint4 wd[kStreams];
    float s[kStreams], wk[kStreams];
#pragma unroll
    for (int q = 0; q < kStreams; ++q) {
      if (k0 + q < K) {
        const int sc = src[(k0 + q) * m + c];
        wd[q] = *reinterpret_cast<const uint4*>(
            words + static_cast<size_t>(sc) * W + w);
        s[q] = sblk[static_cast<size_t>(sc) * n_blocks + blk];
        wk[q] = weights[c * K + k0 + q];
      }
    }
#pragma unroll
    for (int q = 0; q < kStreams; ++q) {
      if (k0 + q < K) {
        accumulate<BITS>(acc[0], wd[q].x, s[q], wk[q]);
        accumulate<BITS>(acc[1], wd[q].y, s[q], wk[q]);
        accumulate<BITS>(acc[2], wd[q].z, s[q], wk[q]);
        accumulate<BITS>(acc[3], wd[q].w, s[q], wk[q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t ai = at + static_cast<size_t>(i) * W;
    float r[kCols] = {acc[0][i], acc[1][i], acc[2][i], acc[3][i]};
    if (MOMENTUM) {
      float vs[kCols], gs[kCols];
      unpack4(*reinterpret_cast<const float4*>(v + ai), vs);
      unpack4(*reinterpret_cast<const float4*>(g + ai), gs);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        r[j] = __fadd_rn(r[j], __fsub_rn(__fmul_rn(theta, vs[j]),
                                         __fmul_rn(eta, gs[j])));
    }
    *reinterpret_cast<float4*>(out + ai) = make_float4(r[0], r[1], r[2],
                                                       r[3]);
  }
}

template <int BITS>
__global__ void dequant_mix_buffer_kernel(const float* __restrict__ base,
                                          const uint32_t* __restrict__ words,
                                          const float* __restrict__ sblk,
                                          const float* __restrict__ weights,
                                          const int* __restrict__ src,
                                          float* __restrict__ out, int m,
                                          int K, int W) {
  mix_columns<BITS, false>(base, words, sblk, weights, src, nullptr,
                           nullptr, out, m, K, W, 0.0f, 0.0f);
}

template <int BITS>
__global__ void dequant_mix_momentum_buffer_kernel(
    const float* __restrict__ base, const uint32_t* __restrict__ words,
    const float* __restrict__ sblk, const float* __restrict__ weights,
    const int* __restrict__ src, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int m, int K,
    int W, float eta, float theta) {
  mix_columns<BITS, true>(base, words, sblk, weights, src, v, g, out, m, K,
                          W, eta, theta);
}

template <int BITS>
__global__ void dequant_mix_plan_kernel(const float* __restrict__ x,
                                        const uint32_t* __restrict__ streams,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ weights,
                                        float* __restrict__ out, int K,
                                        int W) {
  constexpr int PER = 32 / BITS;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = x[static_cast<size_t>(i) * W + w];
  for (int k = 0; k < K; ++k) {
    accumulate<BITS>(acc, streams[static_cast<size_t>(k) * W + w], scales[k],
                     weights[k]);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) out[static_cast<size_t>(i) * W + w] = acc[i];
}

// B8: one thread per 4 columns [w, w + 4); every load is issued before
// the first decode, then own, left and right accumulate in that order.
template <int BITS>
__global__ void __launch_bounds__(kRingThreads)
dequant_mix_ring_kernel(const float* __restrict__ x,
                        const uint32_t* __restrict__ q_own,
                        const uint32_t* __restrict__ q_left,
                        const uint32_t* __restrict__ q_right,
                        const float* __restrict__ scales, float w_self,
                        float w_nb, float* __restrict__ out, int W) {
  constexpr int PER = 32 / BITS;
  const int w = kCols * (blockIdx.x * kRingThreads + threadIdx.x);
  if (w >= W) return;
  // Own's words last: its decode comes first, so it cannot start before
  // every other load is issued.
  float4 xr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    xr[i] = load_now(x + static_cast<size_t>(i) * W + w);
  const uint4 ql = load_now(q_left + w);
  const uint4 qr = load_now(q_right + w);
  const float s_own = load_scalar_now(scales);
  const float s_left = load_scalar_now(scales + 1);
  const float s_right = load_scalar_now(scales + 2);
  const uint4 qo = load_now(q_own + w);
  float acc[kCols][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float b[kCols];
    unpack4(xr[i], b);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j][i] = b[j];
  }
  const uint4 q[3] = {qo, ql, qr};
  const float s[3] = {s_own, s_left, s_right};
  const float wk[3] = {w_self, w_nb, w_nb};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    accumulate<BITS>(acc[0], q[k].x, s[k], wk[k]);
    accumulate<BITS>(acc[1], q[k].y, s[k], wk[k]);
    accumulate<BITS>(acc[2], q[k].z, s[k], wk[k]);
    accumulate<BITS>(acc[3], q[k].w, s[k], wk[k]);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    *reinterpret_cast<float4*>(out + static_cast<size_t>(i) * W + w) =
        make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
}

template <int BITS>
void launch(const float* base, const uint32_t* words, const float* sblk,
            const float* weights, const int* src, const float* v,
            const float* g, float* out, int m, int K, int W, float eta,
            float theta, cudaStream_t stream) {
  const dim3 grid((W / kCols + kThreads - 1) / kThreads, m);
  if (v == nullptr) {
    dequant_mix_buffer_kernel<BITS><<<grid, kThreads, 0, stream>>>(
        base, words, sblk, weights, src, out, m, K, W);
  } else {
    dequant_mix_momentum_buffer_kernel<BITS><<<grid, kThreads, 0, stream>>>(
        base, words, sblk, weights, src, v, g, out, m, K, W, eta, theta);
  }
}

int dispatch_buffer(const void* base, const void* words, const void* sblk,
                    const void* weights, const void* src, const void* v,
                    const void* g, void* out, int m, int K, int W, int bits,
                    float eta, float theta, void* stream) {
  const float* b = static_cast<const float*>(base);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const float* s = static_cast<const float*>(sblk);
  const float* wt = static_cast<const float*>(weights);
  const int* sr = static_cast<const int*>(src);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % kLaneBlock || W < kLaneBlock || m < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2:
      launch<2>(b, wd, s, wt, sr, vf, gf, o, m, K, W, eta, theta, st);
      break;
    case 4:
      launch<4>(b, wd, s, wt, sr, vf, gf, o, m, K, W, eta, theta, st);
      break;
    case 8:
      launch<8>(b, wd, s, wt, sr, vf, gf, o, m, K, W, eta, theta, st);
      break;
    case 16:
      launch<16>(b, wd, s, wt, sr, vf, gf, o, m, K, W, eta, theta, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B2. base, out: f32 [m, 32/bits, W] and words: u32 [m, W], each 16-byte
// aligned, W a multiple of 512; sblk: f32 [m, W/512]; weights: f32 [m, K];
// src: int32 [K, m]. Returns cudaGetLastError().
extern "C" int dequant_mix_buffer(const void* base, const void* words,
                                  const void* sblk, const void* weights,
                                  const void* src, void* out, int m, int K,
                                  int W, int bits, void* stream) {
  return dispatch_buffer(base, words, sblk, weights, src, nullptr, nullptr,
                         out, m, K, W, bits, 0.0f, 0.0f, stream);
}

// B5. As B2, plus v, g: f32 [m, 32/bits, W], 16-byte aligned (the
// deferred step) and runtime eta, theta. Returns cudaGetLastError().
extern "C" int dequant_mix_momentum_buffer(const void* base,
                                           const void* words,
                                           const void* sblk,
                                           const void* weights,
                                           const void* src, const void* v,
                                           const void* g, void* out, int m,
                                           int K, int W, int bits, float eta,
                                           float theta, void* stream) {
  if (v == nullptr || g == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_buffer(base, words, sblk, weights, src, v, g, out, m, K, W,
                         bits, eta, theta, stream);
}

// B7. x, out: f32 [32/bits, W]; streams: u32 [K, W]; scales, weights:
// f32 [K]. Returns cudaGetLastError().
extern "C" int dequant_mix_plan(const void* x, const void* streams,
                                const void* scales, const void* weights,
                                void* out, int K, int W, int bits,
                                void* stream) {
  const float* xf = static_cast<const float*>(x);
  const uint32_t* sw = static_cast<const uint32_t*>(streams);
  const float* sc = static_cast<const float*>(scales);
  const float* wt = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  switch (bits) {
    case 2:
      dequant_mix_plan_kernel<2>
          <<<grid, kThreads, 0, st>>>(xf, sw, sc, wt, o, K, W);
      break;
    case 4:
      dequant_mix_plan_kernel<4>
          <<<grid, kThreads, 0, st>>>(xf, sw, sc, wt, o, K, W);
      break;
    case 8:
      dequant_mix_plan_kernel<8>
          <<<grid, kThreads, 0, st>>>(xf, sw, sc, wt, o, K, W);
      break;
    case 16:
      dequant_mix_plan_kernel<16>
          <<<grid, kThreads, 0, st>>>(xf, sw, sc, wt, o, K, W);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B8. x, out: f32 [32/bits, W] and q_own, q_left, q_right: u32 [W], each
// 16-byte aligned, W a multiple of 512; scales: f32 [3] on the device (own,
// left, right); w_self, w_nb: the static weights rounded to f32. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a bad W or bits).
extern "C" int dequant_mix_ring(const void* x, const void* q_own,
                                const void* q_left, const void* q_right,
                                const void* scales, float w_self, float w_nb,
                                void* out, int W, int bits, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const uint32_t* qo = static_cast<const uint32_t*>(q_own);
  const uint32_t* ql = static_cast<const uint32_t*>(q_left);
  const uint32_t* qr = static_cast<const uint32_t*>(q_right);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % kLaneBlock || W < kLaneBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>(W / kCols / kRingThreads);  // W % 256 == 0
  switch (bits) {
    case 2:
      dequant_mix_ring_kernel<2><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, W);
      break;
    case 4:
      dequant_mix_ring_kernel<4><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, W);
      break;
    case 8:
      dequant_mix_ring_kernel<8><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, W);
      break;
    case 16:
      dequant_mix_ring_kernel<16><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, W);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
