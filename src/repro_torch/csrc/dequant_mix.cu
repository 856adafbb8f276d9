// B2: whole-buffer fused unpack + dequantize + weighted gossip apply.
//
// Replaces: dequant_mix_buffer_pallas, src/repro/kernels/dequant_mix.py:100
// (pallas_call at :115, body _dequant_mix_buffer_kernel at :69).
//
// Computes, for every client c and planar element (i, w):
//   out[c,i,w] = base[c,i,w]
//              + sum_k weight[c,k] * (field_i(words[src[k,c], w]) - 2^(b-1))
//                                   * sblk[src[k,c], w / 512]
// in f32, own stream first (src row 0 is the identity), then the plan
// steps in order — the accumulation order of the JAX kernel.
//
// Bound on the H100: bytes. Per client it reads the base (per * W f32)
// and K word streams (K * W u32) and writes per * W f32; at the 2NN main
// path (m = 16, per = 4, W = 51 712, K = 3) ~36 MB a round, ~10.9 us at
// 3.35 TB/s.
//
// Design: one launch for all m clients, grid (word chunks, clients), one
// thread per word column holding its per accumulators in registers. The
// kernel gathers each neighbour's words and scales through the plan's src
// table itself, so the [m, K, W] stream stack the JAX reference builds is
// never written. Every word load is coalesced (one source client per
// (block, k)). Each multiply and add is a separate _rn intrinsic, so nvcc
// cannot contract them into an FMA and the output is bitwise equal to the
// plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;

template <int BITS>
__global__ void dequant_mix_buffer_kernel(const float* __restrict__ base,
                                          const uint32_t* __restrict__ words,
                                          const float* __restrict__ sblk,
                                          const float* __restrict__ weights,
                                          const int* __restrict__ src,
                                          float* __restrict__ out, int m,
                                          int K, int W, int n_blocks) {
  constexpr int PER = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int OFFSET = 1 << (BITS - 1);
  const int c = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t at = static_cast<size_t>(c) * PER * W + w;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = base[at + static_cast<size_t>(i) * W];
  const int blk = w / kLaneBlock;
  for (int k = 0; k < K; ++k) {
    const int sc = src[k * m + c];
    const uint32_t word = words[static_cast<size_t>(sc) * W + w];
    const float s = sblk[static_cast<size_t>(sc) * n_blocks + blk];
    const float wk = weights[c * K + k];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int field = static_cast<int>((word >> (BITS * i)) & MASK);
      const float deq = __fmul_rn(static_cast<float>(field - OFFSET), s);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, deq));
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) out[at + static_cast<size_t>(i) * W] = acc[i];
}

template <int BITS>
void launch(const float* base, const uint32_t* words, const float* sblk,
            const float* weights, const int* src, float* out, int m, int K,
            int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, m);
  dequant_mix_buffer_kernel<BITS><<<grid, kThreads, 0, stream>>>(
      base, words, sblk, weights, src, out, m, K, W, W / kLaneBlock);
}

}  // namespace

// base, out: f32 [m, 32/bits, W]; words: u32 [m, W]; sblk: f32 [m, W/512];
// weights: f32 [m, K]; src: int32 [K, m]. Returns cudaGetLastError().
extern "C" int dequant_mix_buffer(const void* base, const void* words,
                                  const void* sblk, const void* weights,
                                  const void* src, void* out, int m, int K,
                                  int W, int bits, void* stream) {
  const float* b = static_cast<const float*>(base);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const float* s = static_cast<const float*>(sblk);
  const float* wt = static_cast<const float*>(weights);
  const int* sr = static_cast<const int*>(src);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch<2>(b, wd, s, wt, sr, o, m, K, W, st); break;
    case 4: launch<4>(b, wd, s, wt, sr, o, m, K, W, st); break;
    case 8: launch<8>(b, wd, s, wt, sr, o, m, K, W, st); break;
    case 16: launch<16>(b, wd, s, wt, sr, o, m, K, W, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
