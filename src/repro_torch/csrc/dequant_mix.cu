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
// B8 (dequant_mix_pallas, src/repro/kernels/dequant_mix.py:232, body
//   _dequant_mix_kernel at :27) is B7 at k = 3 with the weights
//   (w_self, w_nb, w_nb): its wrapper launches dequant_mix_plan below.
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
// a [k, W] stream stack.
//
// Bound on the H100: bytes. At the 2NN main path (m = 16, per = 4,
// W = 51 712, K = 3) B2 reads the base and every client's words once
// (the gather form) and writes the output, ~30 MB, ~8.9 us at 3.35 TB/s;
// B5 also reads v and g, ~56 MB, ~16.8 us; B7 and B8 on one client's 2NN
// vector ([4, 50 176], k = 3) move 2.2 MB, ~0.66 us, far below a launch.
//
// Design: grid (word chunks, clients), one thread per word column
// holding its per accumulators in registers. B2 and B5 gather each
// neighbour's words and scales through the plan's src table themselves,
// so the [m, K, W] stream stack the JAX reference builds is never
// written. Every word load is coalesced (one source client per
// (block, k)). Each multiply and add is a separate _rn intrinsic, so nvcc
// cannot contract them into an FMA and the output is bitwise equal to the
// plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;

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

// The body of B2 (MOMENTUM = false) and B5 (MOMENTUM = true) for client
// c and word column w.
template <int BITS, bool MOMENTUM>
__device__ __forceinline__ void mix_column(
    const float* __restrict__ base, const uint32_t* __restrict__ words,
    const float* __restrict__ sblk, const float* __restrict__ weights,
    const int* __restrict__ src, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int m, int K,
    int W, float eta, float theta) {
  constexpr int PER = 32 / BITS;
  const int c = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t at = static_cast<size_t>(c) * PER * W + w;
  const int n_blocks = W / kLaneBlock;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = base[at + static_cast<size_t>(i) * W];
  const int blk = w / kLaneBlock;
  for (int k = 0; k < K; ++k) {
    const int sc = src[k * m + c];
    accumulate<BITS>(acc, words[static_cast<size_t>(sc) * W + w],
                     sblk[static_cast<size_t>(sc) * n_blocks + blk],
                     weights[c * K + k]);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t ai = at + static_cast<size_t>(i) * W;
    if (MOMENTUM) {
      const float vn =
          __fsub_rn(__fmul_rn(theta, v[ai]), __fmul_rn(eta, g[ai]));
      acc[i] = __fadd_rn(acc[i], vn);
    }
    out[ai] = acc[i];
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
  mix_column<BITS, false>(base, words, sblk, weights, src, nullptr, nullptr,
                          out, m, K, W, 0.0f, 0.0f);
}

template <int BITS>
__global__ void dequant_mix_momentum_buffer_kernel(
    const float* __restrict__ base, const uint32_t* __restrict__ words,
    const float* __restrict__ sblk, const float* __restrict__ weights,
    const int* __restrict__ src, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int m, int K,
    int W, float eta, float theta) {
  mix_column<BITS, true>(base, words, sblk, weights, src, v, g, out, m, K,
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

template <int BITS>
void launch(const float* base, const uint32_t* words, const float* sblk,
            const float* weights, const int* src, const float* v,
            const float* g, float* out, int m, int K, int W, float eta,
            float theta, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, m);
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

// B2. base, out: f32 [m, 32/bits, W]; words: u32 [m, W]; sblk: f32
// [m, W/512]; weights: f32 [m, K]; src: int32 [K, m]. Returns
// cudaGetLastError().
extern "C" int dequant_mix_buffer(const void* base, const void* words,
                                  const void* sblk, const void* weights,
                                  const void* src, void* out, int m, int K,
                                  int W, int bits, void* stream) {
  return dispatch_buffer(base, words, sblk, weights, src, nullptr, nullptr,
                         out, m, K, W, bits, 0.0f, 0.0f, stream);
}

// B5. As B2, plus v, g: f32 [m, 32/bits, W] (the deferred step) and
// runtime eta, theta. Returns cudaGetLastError().
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

// B7 (and B8 at K = 3). x, out: f32 [32/bits, W]; streams: u32 [K, W];
// scales, weights: f32 [K]. Returns cudaGetLastError().
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
