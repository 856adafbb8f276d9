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
// steps in order — the accumulation order of the JAX kernel. words and
// sblk hold R >= m rows: on one device R = m (every client's own
// stream); on a shard of a client mesh the shard's m_local own rows come
// first, then the boundary rows it received, and src indexes the whole
// table, so the intra-shard gathers and the received lanes are entries
// of one table. A src entry outside [0, R) is never read: that client's
// output is NaN (the host checks its tables; a kernel cannot raise). B5
// adds the round's deferred heavy-ball step (theta * v - eta * g) to the
// f32 accumulator before the store. B7 is the per-tensor form over one
// client: out = x + sum_k weight[k] * (field_k - 2^(b-1)) * scale[k] over
// a [k, W] stream stack. B8 is the ring's k = 3 with the weights (w_self,
// w_nb, w_nb): own, then left, then right. B7 and B8 read x as the flat
// [n] vector the per-tensor entry points hold (element (i, w) of the
// planar [per, W] view is x[i * W + w], zero past n) and write only
// out[:n], so no padded copy of x is made; their Pallas-shaped callers
// pass n = per * W.
//
// Bound on the H100: bytes. At the 2NN main path (m = 16, per = 4,
// W = 51 712, K = 3) B2 reads the base and every client's words once
// (the gather form) and writes the output, ~30 MB, ~8.9 us at 3.35 TB/s;
// B5 also reads v and g, ~56 MB, ~16.8 us; B7 and B8 on one client's 2NN
// vector ([4, 50 176], k = 3) move 2.2 MB, ~0.66 us, far below a launch:
// what bounds them there is the launch and the DRAM latency of their
// loads. B7 on a SmolLM-135M vector (n = 134 515 008, 8 bits) moves
// 1.75 GB at k = 5, ~522 us, where bytes bound it.
//
// Design: grid (word chunks, clients). B2 and B5 gather each neighbour's
// words and scales through the plan's src table themselves, so the
// [m, K, W] stream stack the JAX reference builds is never written. A
// thread of any of these kernels holds 4 consecutive word columns and
// their per x 4 accumulators in registers: one 16-byte load of base (B5:
// and of v and g) per planar row, one 16-byte load of the 4 words per
// stream, one 16-byte store per row; neighbouring threads hold
// neighbouring columns, so every access is coalesced (one source client
// per (block, k)). W is a multiple of 512, so rows stay 16-byte aligned
// and a thread's columns share one lane block, hence one scale per stream.
// src[k, c] and w[c, k] are uniform across a block: a B2/B5 thread reads
// them, and its streams' scales, for up to kStreams streams at a time
// before any word of those streams is decoded, so their word loads are in
// flight together (the ring's K = 3 is one group). B7 and B8 are built for
// latency at one client's vector: a thread issues every load it needs —
// its per rows of x, each stream's 16-byte words, each stream's scale and
// weight — before it decodes anything (load_now: the compiler would
// otherwise sink each stream's loads to its decode), own stream's words
// last, so the whole job is one DRAM round trip. B7 knows K at compile
// time up to kPlanStatic streams, as the JAX kernel compiles n_streams
// statically; a larger K (the complete graph has k = m) goes in
// compile-time groups of kPlanStatic, each group's loads issued before
// its decode, k ascending. Its scales and weights stay on the device (the
// weights may be a round's gathered mask) and are read through the L1
// (load_uniform_now): a volatile load of a value every warp reads goes to
// the L2 once a warp. B8 takes its three streams as three pointers (no
// [3, W] stack, no weight tensor: the weights come by value). A thread
// whose rows all lie below n in a 16-byte aligned x moves each row as
// one 16-byte access; a thread of the tail, or any thread of a
// misaligned x, takes a predicated 4-byte load for each value below n in
// the same kernel. 4 columns a thread is W / 4 = 12 544 threads at the
// 2NN vector; blocks of 64 make that 196 blocks, so every one of the 132
// SMs holds one (blocks of 256 would leave 83 SMs idle). Each multiply
// and add is a separate _rn intrinsic, so nvcc cannot contract them into
// an FMA and the output is bitwise equal to the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;
constexpr int kCols = 4;      // word columns a B2/B5 thread decodes
constexpr int kStreams = 4;   // streams whose words a B2/B5 thread loads
                              // before decoding any of them
constexpr int kRingThreads = 64;  // B8's block: >= 132 blocks at W = 50 176
constexpr int kPlanStatic = 8;    // B7: K known at compile time up to this
// B7's block: 196 blocks at the 2NN vector's W = 50 176, so every SM
// holds one; blocks of 128 and 256 are no faster at the SmolLM-135M
// vector (PERF.md).
constexpr int kPlanThreads = 64;

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
// sink each of B7's and B8's loads to just before its first use, so a
// stream's words are only asked for after the previous stream is decoded
// (a DRAM round trip per stream); volatile loads keep their order, so B7
// and B8 issue their own stream's words last, and every load is in flight
// before the first decode. A host build reads plainly.
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

// A value every thread of a block reads (a stream's scale or weight),
// issued in the order written like load_now, but through the L1: relaxed
// at block scope, so the block's warps after the first hit the L1 rather
// than each asking the L2 (a volatile load cannot be served by the L1).
__device__ __forceinline__ float load_uniform_now(const float* p) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile("ld.relaxed.cta.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}

// *p where on, else 0: a predicated 4-byte load, issued in the order
// written (as load_now). The destination is zeroed inside the asm, so the
// load waits on no earlier value.
__device__ __forceinline__ float load_scalar_now_if(const float* p, int on) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.s32 p, %1, 0;\n"
      " mov.f32 %0, 0f00000000;\n"
      " @p ld.volatile.global.f32 %0, [%2];\n}"
      : "=f"(v)
      : "r"(on), "l"(p));
  return v;
#else
  return on ? *p : 0.0f;
#endif
}

// A B7/B8 thread's rows of a flat x [n] read as its planar [PER, W] view:
// rows[i] = x[i * W + w .. i * W + w + 3], zero past n. fast: every row
// lies below n and x is 16-byte aligned, so a row is one 16-byte load;
// else (the threads of the tail, or a misaligned x) each value below n is
// one predicated 4-byte load. Either way every load is issued in the
// order written, before anything is decoded.
template <int PER>
__device__ __forceinline__ void load_rows(float4 (&rows)[PER],
                                          const float* x, int w, int W,
                                          int64_t n, bool fast) {
  if (fast) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      rows[i] = load_now(x + static_cast<size_t>(i) * W + w);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int64_t e = static_cast<int64_t>(i) * W + w;
      rows[i].x = load_scalar_now_if(x + e, e < n);
      rows[i].y = load_scalar_now_if(x + e + 1, e + 1 < n);
      rows[i].z = load_scalar_now_if(x + e + 2, e + 2 < n);
      rows[i].w = load_scalar_now_if(x + e + 3, e + 3 < n);
    }
  }
}

// Store a B7/B8 thread's accumulators to a flat out [n], the values below
// n only: a 16-byte store a row where fast (as load_rows), else a 4-byte
// store for each value below n.
template <int PER>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[kCols][PER],
                                           int w, int W, int64_t n,
                                           bool fast) {
  if (fast) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(i) * W + w) =
          make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int64_t e = static_cast<int64_t>(i) * W + w;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (e + j < n) out[e + j] = acc[j][i];
    }
  }
}

// The body of B2 (MOMENTUM = false) and B5 (MOMENTUM = true) for client
// c and word columns [w, w + 4).
template <int BITS, bool MOMENTUM>
__device__ __forceinline__ void mix_columns(
    const float* __restrict__ base, const uint32_t* __restrict__ words,
    const float* __restrict__ sblk, const float* __restrict__ weights,
    const int* __restrict__ src, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int m, int R,
    int K, int W, float eta, float theta) {
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
  bool bad = false;
  for (int k0 = 0; k0 < K; k0 += kStreams) {
    uint4 wd[kStreams];
    float s[kStreams], wk[kStreams];
#pragma unroll
    for (int q = 0; q < kStreams; ++q) {
      if (k0 + q < K) {
        int sc = src[(k0 + q) * m + c];
        if (sc < 0 || sc >= R) {
          bad = true;
          sc = 0;
        }
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
    if (bad) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) r[j] = __uint_as_float(0x7fc00000u);
    }
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
                                          int R, int K, int W) {
  mix_columns<BITS, false>(base, words, sblk, weights, src, nullptr,
                           nullptr, out, m, R, K, W, 0.0f, 0.0f);
}

template <int BITS>
__global__ void dequant_mix_momentum_buffer_kernel(
    const float* __restrict__ base, const uint32_t* __restrict__ words,
    const float* __restrict__ sblk, const float* __restrict__ weights,
    const int* __restrict__ src, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int m, int R,
    int K, int W, float eta, float theta) {
  mix_columns<BITS, true>(base, words, sblk, weights, src, v, g, out, m, R,
                          K, W, eta, theta);
}

// B7 streams [k0, k0 + g) for one thread's 4 columns [w, w + 4), g <= G:
// the words of streams k0 + 1 .. k0 + g - 1, every scale and weight, then
// stream k0's words (decoded first, so it cannot start early) are all
// issued, then the streams accumulate in order. With g = G a compile-time
// constant the guards fold away.
template <int BITS, int G>
__device__ __forceinline__ void plan_streams(
    float (&acc)[kCols][32 / BITS], const uint32_t* __restrict__ streams,
    const float* __restrict__ scales, const float* __restrict__ weights,
    int k0, int g, int W, int w) {
  uint4 q[G];
  float s[G], wk[G];
#pragma unroll
  for (int j = 1; j < G; ++j)
    if (j < g) q[j] = load_now(streams + static_cast<size_t>(k0 + j) * W + w);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < g) {
      s[j] = load_uniform_now(scales + k0 + j);
      wk[j] = load_uniform_now(weights + k0 + j);
    }
  }
  q[0] = load_now(streams + static_cast<size_t>(k0) * W + w);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < g) {
      accumulate<BITS>(acc[0], q[j].x, s[j], wk[j]);
      accumulate<BITS>(acc[1], q[j].y, s[j], wk[j]);
      accumulate<BITS>(acc[2], q[j].z, s[j], wk[j]);
      accumulate<BITS>(acc[3], q[j].w, s[j], wk[j]);
    }
  }
}

// B7: one thread per 4 columns [w, w + 4) of the planar view of a flat
// x [n]. KS = K streams known at compile time (1 .. kPlanStatic), or 0:
// K > kPlanStatic at run time, in groups of kPlanStatic.
template <int BITS, int KS>
__global__ void __launch_bounds__(kPlanThreads)
dequant_mix_plan_kernel(const float* __restrict__ x,
                        const uint32_t* __restrict__ streams,
                        const float* __restrict__ scales,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int64_t n, int K, int W,
                        bool vec) {
  constexpr int PER = 32 / BITS;
  const int w = kCols * (blockIdx.x * kPlanThreads + threadIdx.x);
  if (w >= W || w >= n) return;           // past n in every row
  const bool fast = vec && static_cast<int64_t>(PER - 1) * W + w + kCols <= n;
  float4 xr[PER];
  load_rows<PER>(xr, x, w, W, n, fast);
  float acc[kCols][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float b[kCols];
    unpack4(xr[i], b);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j][i] = b[j];
  }
  if constexpr (KS > 0) {
    plan_streams<BITS, KS>(acc, streams, scales, weights, 0, KS, W, w);
  } else {
    for (int k0 = 0; k0 < K; k0 += kPlanStatic)
      plan_streams<BITS, kPlanStatic>(
          acc, streams, scales, weights, k0,
          K - k0 < kPlanStatic ? K - k0 : kPlanStatic, W, w);
  }
  store_rows<PER>(out, acc, w, W, n, fast);
}

// B8: one thread per 4 columns [w, w + 4) of the planar view of a flat
// x [n]; every load is issued before the first decode, then own, left and
// right accumulate in that order.
template <int BITS>
__global__ void __launch_bounds__(kRingThreads)
dequant_mix_ring_kernel(const float* __restrict__ x,
                        const uint32_t* __restrict__ q_own,
                        const uint32_t* __restrict__ q_left,
                        const uint32_t* __restrict__ q_right,
                        const float* __restrict__ scales, float w_self,
                        float w_nb, float* __restrict__ out, int64_t n,
                        int W, bool vec) {
  constexpr int PER = 32 / BITS;
  const int w = kCols * (blockIdx.x * kRingThreads + threadIdx.x);
  if (w >= W || w >= n) return;           // past n in every row
  const bool fast = vec && static_cast<int64_t>(PER - 1) * W + w + kCols <= n;
  // Own's words last: its decode comes first, so it cannot start before
  // every other load is issued.
  float4 xr[PER];
  load_rows<PER>(xr, x, w, W, n, fast);
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
  store_rows<PER>(out, acc, w, W, n, fast);
}

template <int BITS>
void launch(const float* base, const uint32_t* words, const float* sblk,
            const float* weights, const int* src, const float* v,
            const float* g, float* out, int m, int R, int K, int W,
            float eta, float theta, cudaStream_t stream) {
  const dim3 grid((W / kCols + kThreads - 1) / kThreads, m);
  if (v == nullptr) {
    dequant_mix_buffer_kernel<BITS><<<grid, kThreads, 0, stream>>>(
        base, words, sblk, weights, src, out, m, R, K, W);
  } else {
    dequant_mix_momentum_buffer_kernel<BITS><<<grid, kThreads, 0, stream>>>(
        base, words, sblk, weights, src, v, g, out, m, R, K, W, eta, theta);
  }
}

int dispatch_buffer(const void* base, const void* words, const void* sblk,
                    const void* weights, const void* src, const void* v,
                    const void* g, void* out, int m, int R, int K, int W,
                    int bits, float eta, float theta, void* stream) {
  const float* b = static_cast<const float*>(base);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const float* s = static_cast<const float*>(sblk);
  const float* wt = static_cast<const float*>(weights);
  const int* sr = static_cast<const int*>(src);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % kLaneBlock || W < kLaneBlock || m < 1 || m > 65535 || R < m ||
      K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2:
      launch<2>(b, wd, s, wt, sr, vf, gf, o, m, R, K, W, eta, theta, st);
      break;
    case 4:
      launch<4>(b, wd, s, wt, sr, vf, gf, o, m, R, K, W, eta, theta, st);
      break;
    case 8:
      launch<8>(b, wd, s, wt, sr, vf, gf, o, m, R, K, W, eta, theta, st);
      break;
    case 16:
      launch<16>(b, wd, s, wt, sr, vf, gf, o, m, R, K, W, eta, theta, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether n values fill the planar [32/bits, W] view as planar_pad_len
// sizes it: W a multiple of 512 and per * (W - 512) < n <= per * W.
bool flat_shape_ok(int64_t n, int W, int bits) {
  const int64_t per = 32 / bits;
  return W >= kLaneBlock && W % kLaneBlock == 0 && n <= per * W &&
         n > per * (W - kLaneBlock);
}

bool bits_ok(int bits) {
  return bits == 2 || bits == 4 || bits == 8 || bits == 16;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// B7's launch for K streams: the kernel with K fixed at compile time for
// K <= kPlanStatic, else the grouped one (KS = 0).
template <int BITS, int KS = kPlanStatic>
void launch_plan(unsigned grid, cudaStream_t st,
                 const float* x, const uint32_t* q, const float* sc,
                 const float* wt, float* o, int64_t n, int K, int W,
                 bool vec) {
  if constexpr (KS > 0) {
    if (K != KS) {
      launch_plan<BITS, KS - 1>(grid, st, x, q, sc, wt, o, n, K, W, vec);
      return;
    }
  }
  dequant_mix_plan_kernel<BITS, KS><<<grid, kPlanThreads, 0, st>>>(
      x, q, sc, wt, o, n, K, W, vec);
}

}  // namespace

// B2. base, out: f32 [m, 32/bits, W] and words: u32 [R, W], each 16-byte
// aligned, W a multiple of 512; sblk: f32 [R, W/512]; weights: f32 [m, K];
// src: int32 [K, m] with entries in [0, R), R >= m rows of words and
// scales. Returns cudaGetLastError() (cudaErrorInvalidValue for a bad
// shape: W, m outside [1, 65535], R < m, K < 1, or bits).
extern "C" int dequant_mix_buffer(const void* base, const void* words,
                                  const void* sblk, const void* weights,
                                  const void* src, void* out, int m, int R,
                                  int K, int W, int bits, void* stream) {
  return dispatch_buffer(base, words, sblk, weights, src, nullptr, nullptr,
                         out, m, R, K, W, bits, 0.0f, 0.0f, stream);
}

// B5. As B2 (R rows of words and scales), plus v, g: f32 [m, 32/bits, W],
// 16-byte aligned (the deferred step) and runtime eta, theta. Returns
// cudaGetLastError().
extern "C" int dequant_mix_momentum_buffer(const void* base,
                                           const void* words,
                                           const void* sblk,
                                           const void* weights,
                                           const void* src, const void* v,
                                           const void* g, void* out, int m,
                                           int R, int K, int W, int bits,
                                           float eta, float theta,
                                           void* stream) {
  if (v == nullptr || g == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_buffer(base, words, sblk, weights, src, v, g, out, m, R, K,
                         W, bits, eta, theta, stream);
}

// B7. x: f32 [n], any 4-byte alignment, read as its planar [32/bits, W]
// view, zero past n; out: f32 [n], only [:n] written; streams: u32 [K, W],
// 16-byte aligned; scales, weights: f32 [K] on the device. W must be the
// width planar_pad_len gives n (a multiple of 512, per * (W - 512) < n <=
// per * W); K >= 1. Returns cudaGetLastError() (or cudaErrorInvalidValue
// for a bad shape, bits or stream alignment).
extern "C" int dequant_mix_plan(const void* x, const void* streams,
                                const void* scales, const void* weights,
                                void* out, int64_t n, int K, int W, int bits,
                                void* stream) {
  const float* xf = static_cast<const float*>(x);
  const uint32_t* sw = static_cast<const uint32_t*>(streams);
  const float* sc = static_cast<const float*>(scales);
  const float* wt = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bits_ok(bits) || !flat_shape_ok(n, W, bits) || K < 1 ||
      !aligned16(streams))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(x) && aligned16(out);
  const unsigned grid =
      static_cast<unsigned>((W / kCols + kPlanThreads - 1) / kPlanThreads);
  switch (bits) {
    case 2:
      launch_plan<2>(grid, st, xf, sw, sc, wt, o, n, K, W, vec);
      break;
    case 4:
      launch_plan<4>(grid, st, xf, sw, sc, wt, o, n, K, W, vec);
      break;
    case 8:
      launch_plan<8>(grid, st, xf, sw, sc, wt, o, n, K, W, vec);
      break;
    default:
      launch_plan<16>(grid, st, xf, sw, sc, wt, o, n, K, W, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// B8. x: f32 [n], any 4-byte alignment, read as its planar [32/bits, W]
// view, zero past n; out: f32 [n], only [:n] written; q_own, q_left,
// q_right: u32 [W], each 16-byte aligned, W the width planar_pad_len
// gives n; scales: f32 [3] on the device (own, left, right); w_self, w_nb:
// the static weights rounded to f32. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a bad shape, bits or stream alignment).
extern "C" int dequant_mix_ring(const void* x, const void* q_own,
                                const void* q_left, const void* q_right,
                                const void* scales, float w_self, float w_nb,
                                void* out, int64_t n, int W, int bits,
                                void* stream) {
  const float* xf = static_cast<const float*>(x);
  const uint32_t* qo = static_cast<const uint32_t*>(q_own);
  const uint32_t* ql = static_cast<const uint32_t*>(q_left);
  const uint32_t* qr = static_cast<const uint32_t*>(q_right);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bits_ok(bits) || !flat_shape_ok(n, W, bits) || !aligned16(q_own) ||
      !aligned16(q_left) || !aligned16(q_right))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(x) && aligned16(out);
  const unsigned grid =
      static_cast<unsigned>(W / kCols / kRingThreads);  // W % 256 == 0
  switch (bits) {
    case 2:
      dequant_mix_ring_kernel<2><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, n, W, vec);
      break;
    case 4:
      dequant_mix_ring_kernel<4><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, n, W, vec);
      break;
    case 8:
      dequant_mix_ring_kernel<8><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, n, W, vec);
      break;
    default:
      dequant_mix_ring_kernel<16><<<grid, kRingThreads, 0, st>>>(
          xf, qo, ql, qr, sc, w_self, w_nb, o, n, W, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
