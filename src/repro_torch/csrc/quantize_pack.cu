// B1: whole-buffer b-bit quantize + planar bit-pack (the wire encoder).
//
// Replaces: quantize_pack_buffer_pallas, src/repro/kernels/quantize_pack.py:48
// (pallas_call at :68, body _quantize_pack_kernel at :29).
//
// Computes, for every client c and word column w of a planar [per, W]
// buffer (per = 32 / bits):
//   a = x / s_blk ; k = floor(a) ; k += (noise < a - k)  [stochastic]
//   k = clip(k, qmin, qmax) ; word = OR_i (k_i + 2^(b-1)) << (b * i)
// with s_blk the scale of the lane block (512 words) that owns column w.
//
// Bound on the H100: bytes. Per client it reads x and noise (2 * per * W
// f32) and writes W words; at the 2NN main path (m = 16, per = 4,
// W = 51 712) that is ~30 MB a round, ~8.9 us at 3.35 TB/s.
//
// Design: one launch for all m clients, grid (word chunks, clients), one
// thread per word column. Neighbouring threads read neighbouring columns
// of each planar row, so every load and the store are coalesced. The
// fields of a word are built in registers and stored once. Rounding is
// pinned with the _rn intrinsics so the words are bitwise equal to the
// plain PyTorch version (IEEE division, no contraction).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;

template <int BITS, bool STOCHASTIC>
__global__ void quantize_pack_buffer_kernel(const float* __restrict__ x,
                                            const float* __restrict__ noise,
                                            const float* __restrict__ sblk,
                                            uint32_t* __restrict__ out,
                                            int W, int n_blocks) {
  constexpr int PER = 32 / BITS;
  constexpr float QMIN = -static_cast<float>(1 << (BITS - 1));
  constexpr float QMAX = static_cast<float>((1 << (BITS - 1)) - 1);
  constexpr int OFFSET = 1 << (BITS - 1);
  const int c = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const float s = sblk[static_cast<size_t>(c) * n_blocks + w / kLaneBlock];
  const size_t base = static_cast<size_t>(c) * PER * W + w;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t at = base + static_cast<size_t>(i) * W;
    const float a = __fdiv_rn(x[at], s);
    float k = floorf(a);
    if (STOCHASTIC) {
      if (noise[at] < __fsub_rn(a, k)) k = __fadd_rn(k, 1.0f);
    }
    k = fminf(fmaxf(k, QMIN), QMAX);
    const uint32_t field = static_cast<uint32_t>(static_cast<int>(k) + OFFSET);
    word |= field << (BITS * i);
  }
  out[static_cast<size_t>(c) * W + w] = word;
}

template <int BITS>
void launch(const float* x, const float* noise, const float* sblk,
            uint32_t* out, int m, int W, int stochastic,
            cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, m);
  const int n_blocks = W / kLaneBlock;
  if (stochastic) {
    quantize_pack_buffer_kernel<BITS, true>
        <<<grid, kThreads, 0, stream>>>(x, noise, sblk, out, W, n_blocks);
  } else {
    quantize_pack_buffer_kernel<BITS, false>
        <<<grid, kThreads, 0, stream>>>(x, noise, sblk, out, W, n_blocks);
  }
}

}  // namespace

// x, noise: f32 [m, 32/bits, W]; sblk: f32 [m, W/512]; out: u32 [m, W].
// noise may be null when stochastic == 0. Returns cudaGetLastError().
extern "C" int quantize_pack_buffer(const void* x, const void* noise,
                                    const void* sblk, void* out, int m,
                                    int W, int bits, int stochastic,
                                    void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(noise);
  const float* sf = static_cast<const float*>(sblk);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch<2>(xf, nf, sf, o, m, W, stochastic, st); break;
    case 4: launch<4>(xf, nf, sf, o, m, W, stochastic, st); break;
    case 8: launch<8>(xf, nf, sf, o, m, W, stochastic, st); break;
    case 16: launch<16>(xf, nf, sf, o, m, W, stochastic, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
