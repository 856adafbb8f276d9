// The wire encoders: b-bit quantize + planar bit-pack.
//
// B1, quantize_pack_buffer — replaces quantize_pack_buffer_pallas,
//   src/repro/kernels/quantize_pack.py:48 (pallas_call at :68, body
//   _quantize_pack_kernel at :29).
// B4, momentum_quantize_pack_buffer — replaces
//   momentum_quantize_pack_buffer_pallas,
//   src/repro/kernels/quantize_pack.py:121
//   (pallas_call at :147, body _momentum_quantize_pack_kernel at :82).
// B6, quantize_pack — replaces quantize_pack_pallas,
//   src/repro/kernels/quantize_pack.py:166 (pallas_call at :177, the same
//   body _quantize_pack_kernel). B1's kernel with one scale: the scale
//   stride is 0 and m = 1, as the JAX package runs one body for both.
//
// Computes, for every client c and word column w of a planar [per, W]
// buffer (per = 32 / bits):
//   a = x / s_blk ; k = floor(a) ; k += (noise < a - k)  [stochastic]
//   k = clip(k, qmin, qmax) ; word = OR_i (k_i + 2^(b-1)) << (b * i)
// with s_blk the scale of the lane block (512 words) that owns column w.
// B4 first applies the round's penultimate heavy-ball step and encodes
// its delta from the held parameters:
//   v' = theta * v - eta * g ; y' = y + v' ; x = y' - x_held
// and writes y' and v' beside the words.
//
// Bound on the H100: bytes. At the 2NN main path (m = 16, per = 4,
// W = 51 712) B1 reads x and noise and writes the words, ~30 MB a round,
// ~8.9 us at 3.35 TB/s; B4 reads y, v, g, x_held and noise and writes y',
// v' and the words, ~96 MB, ~28.6 us; B6 on one client's 2NN vector
// ([4, 50 176]) moves 1.8 MB, ~0.54 us, far below a launch.
//
// Design: one launch for all m clients, grid (word chunks, clients), one
// thread per word column. Neighbouring threads read neighbouring columns
// of each planar row, so every load and the store are coalesced. The
// fields of a word are built in registers and stored once. Rounding is
// pinned with the _rn intrinsics so the words (and B4's y', v') are
// bitwise equal to the plain PyTorch version (IEEE division, no
// contraction of theta * v - eta * g into an FMA).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;

// Offset-encoded field of one value: quantize x / s to a level in
// [qmin, qmax] (stochastic: round up when u < a - floor(a)).
template <int BITS, bool STOCHASTIC>
__device__ __forceinline__ uint32_t quantize_field(float x, float s,
                                                   float u) {
  constexpr float QMIN = -static_cast<float>(1 << (BITS - 1));
  constexpr float QMAX = static_cast<float>((1 << (BITS - 1)) - 1);
  constexpr int OFFSET = 1 << (BITS - 1);
  const float a = __fdiv_rn(x, s);
  float k = floorf(a);
  if (STOCHASTIC) {
    if (u < __fsub_rn(a, k)) k = __fadd_rn(k, 1.0f);
  }
  k = fminf(fmaxf(k, QMIN), QMAX);
  return static_cast<uint32_t>(static_cast<int>(k) + OFFSET);
}

// s_stride is the distance between two lane blocks' scales: 1 for the
// per-block scales of B1, 0 for B6's single scale.
template <int BITS, bool STOCHASTIC>
__global__ void quantize_pack_buffer_kernel(const float* __restrict__ x,
                                            const float* __restrict__ noise,
                                            const float* __restrict__ sblk,
                                            uint32_t* __restrict__ out,
                                            int W, int n_blocks,
                                            int s_stride) {
  constexpr int PER = 32 / BITS;
  const int c = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const float s = sblk[(static_cast<size_t>(c) * n_blocks + w / kLaneBlock)
                       * s_stride];
  const size_t base = static_cast<size_t>(c) * PER * W + w;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t at = base + static_cast<size_t>(i) * W;
    const float u = STOCHASTIC ? noise[at] : 0.0f;
    word |= quantize_field<BITS, STOCHASTIC>(x[at], s, u) << (BITS * i);
  }
  out[static_cast<size_t>(c) * W + w] = word;
}

template <int BITS, bool STOCHASTIC>
__global__ void momentum_quantize_pack_buffer_kernel(
    const float* __restrict__ y, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ noise, const float* __restrict__ sblk,
    float* __restrict__ y_out, float* __restrict__ v_out,
    uint32_t* __restrict__ out, int W, int n_blocks, float eta,
    float theta) {
  constexpr int PER = 32 / BITS;
  const int c = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const float s = sblk[static_cast<size_t>(c) * n_blocks + w / kLaneBlock];
  const size_t base = static_cast<size_t>(c) * PER * W + w;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t at = base + static_cast<size_t>(i) * W;
    const float vn = __fsub_rn(__fmul_rn(theta, v[at]), __fmul_rn(eta, g[at]));
    const float yn = __fadd_rn(y[at], vn);
    v_out[at] = vn;
    y_out[at] = yn;
    const float u = STOCHASTIC ? noise[at] : 0.0f;
    word |= quantize_field<BITS, STOCHASTIC>(__fsub_rn(yn, x[at]), s, u)
            << (BITS * i);
  }
  out[static_cast<size_t>(c) * W + w] = word;
}

template <int BITS>
void launch(const float* x, const float* noise, const float* sblk,
            uint32_t* out, int m, int W, int s_stride, int stochastic,
            cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, m);
  const int n_blocks = W / kLaneBlock;
  if (stochastic) {
    quantize_pack_buffer_kernel<BITS, true><<<grid, kThreads, 0, stream>>>(
        x, noise, sblk, out, W, n_blocks, s_stride);
  } else {
    quantize_pack_buffer_kernel<BITS, false><<<grid, kThreads, 0, stream>>>(
        x, noise, sblk, out, W, n_blocks, s_stride);
  }
}

template <int BITS>
void launch_momentum(const float* y, const float* v, const float* g,
                     const float* x, const float* noise, const float* sblk,
                     float* y_out, float* v_out, uint32_t* out, int m, int W,
                     float eta, float theta, int stochastic,
                     cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, m);
  const int n_blocks = W / kLaneBlock;
  if (stochastic) {
    momentum_quantize_pack_buffer_kernel<BITS, true>
        <<<grid, kThreads, 0, stream>>>(y, v, g, x, noise, sblk, y_out,
                                        v_out, out, W, n_blocks, eta, theta);
  } else {
    momentum_quantize_pack_buffer_kernel<BITS, false>
        <<<grid, kThreads, 0, stream>>>(y, v, g, x, noise, sblk, y_out,
                                        v_out, out, W, n_blocks, eta, theta);
  }
}

int dispatch(const void* x, const void* noise, const void* sblk, void* out,
             int m, int W, int bits, int s_stride, int stochastic,
             void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(noise);
  const float* sf = static_cast<const float*>(sblk);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch<2>(xf, nf, sf, o, m, W, s_stride, stochastic, st); break;
    case 4: launch<4>(xf, nf, sf, o, m, W, s_stride, stochastic, st); break;
    case 8: launch<8>(xf, nf, sf, o, m, W, s_stride, stochastic, st); break;
    case 16: launch<16>(xf, nf, sf, o, m, W, s_stride, stochastic, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1. x, noise: f32 [m, 32/bits, W]; sblk: f32 [m, W/512]; out: u32 [m, W].
// noise may be null when stochastic == 0. Returns cudaGetLastError().
extern "C" int quantize_pack_buffer(const void* x, const void* noise,
                                    const void* sblk, void* out, int m,
                                    int W, int bits, int stochastic,
                                    void* stream) {
  return dispatch(x, noise, sblk, out, m, W, bits, 1, stochastic, stream);
}

// B6. x, noise: f32 [32/bits, W]; s: f32 [1] (device); out: u32 [W].
// noise may be null when stochastic == 0. Returns cudaGetLastError().
extern "C" int quantize_pack(const void* x, const void* noise, const void* s,
                             void* out, int W, int bits, int stochastic,
                             void* stream) {
  return dispatch(x, noise, s, out, 1, W, bits, 0, stochastic, stream);
}

// B4. y, v, g, x, noise, y_out, v_out: f32 [m, 32/bits, W]; sblk: f32
// [m, W/512]; out: u32 [m, W]. noise may be null when stochastic == 0.
// Returns cudaGetLastError().
extern "C" int momentum_quantize_pack_buffer(
    const void* y, const void* v, const void* g, const void* x,
    const void* noise, const void* sblk, void* y_out, void* v_out, void* out,
    int m, int W, int bits, float eta, float theta, int stochastic,
    void* stream) {
  const float* yf = static_cast<const float*>(y);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(noise);
  const float* sf = static_cast<const float*>(sblk);
  float* yo = static_cast<float*>(y_out);
  float* vo = static_cast<float*>(v_out);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_momentum<2>(yf, vf, gf, xf, nf, sf, yo, vo, o, m, W, eta,
                               theta, stochastic, st); break;
    case 4: launch_momentum<4>(yf, vf, gf, xf, nf, sf, yo, vo, o, m, W, eta,
                               theta, stochastic, st); break;
    case 8: launch_momentum<8>(yf, vf, gf, xf, nf, sf, yo, vo, o, m, W, eta,
                               theta, stochastic, st); break;
    case 16: launch_momentum<16>(yf, vf, gf, xf, nf, sf, yo, vo, o, m, W, eta,
                                 theta, stochastic, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
