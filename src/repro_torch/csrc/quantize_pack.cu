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
// Bound on the H100. B1 keyed (the main path: m = 16, per = 4, W = 51 712)
// reads x and the scales and writes the words, ~16.6 MB, ~4.9 us at 3.35
// TB/s; but it also draws its own noise, a threefry hash for each of the
// 3 187 360 real values, so its bound is set by operations: chip_smoke.py
// counts the compiled kernel's instructions by pipe (cuobjdump -sass) and
// takes the busiest pipe at its peak rate. B4 reads y, v, g, x_held and
// noise and writes y', v' and the words, ~96 MB, ~28.6 us (bytes); B6 on one
// client's 2NN vector ([4, 50 176]) moves 1.8 MB, ~0.54 us, far below a
// launch.
//
// Design of B1/B6: one launch for all m clients, grid (column chunks,
// clients). Each thread packs 4 consecutive word columns: per planar row one
// 16-byte load of x (and of the noise in tensor mode), one 16-byte store of
// its 4 words; neighbouring threads hold neighbouring columns, so every
// access is coalesced. W is a multiple of 512, so rows stay 16-byte aligned
// and 4 columns never straddle a lane block. The noise source is a template
// parameter: none (deterministic floor), tensor (a [m, per, W] f32 input, B6
// and the fused round's callers) or keyed. Keyed, the kernel draws the
// stochastic-rounding noise itself: the wrapper passes the raw per-leaf keys
// [n_leaves, m, 2] (int64, truncated to u32 here) and the layout's leaf
// table (word offset, leaf words, size), which the C entry hands the kernel
// BY VALUE, 64 leaves a launch; position (c, i, w) of leaf l draws element
// i * leaf_words[l] + (w - word_offset[l]) of uniform(keys[l, c]) with
// threefry.cuh when that index is below size[l] (padding draws 0). That is
// the noise the plain version is fed (WireLayout.noise_stacked), bit for
// bit, and a 13 MB input that is never written or read. A warp's 128 columns
// lie in one lane block, so the leaf and its key are uniform across the
// warp. B4 keeps one thread per column and tensor noise. The fields of a
// word are built in registers and stored once. Rounding is pinned with the
// _rn intrinsics so the words (and B4's y', v') are bitwise equal to the
// plain PyTorch version (IEEE division, no contraction of
// theta * v - eta * g into an FMA).
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;
constexpr int kCols = 4;          // word columns a B1 thread packs
constexpr int kMaxKeyedLeaves = 64;

enum class Noise { kNone, kTensor, kKeyed };

// The layout's leaves served by one keyed launch (by value): leaf l owns
// columns [word_offset[l], word_offset[l] + leaf_words[l]) and size[l] real
// values; its keys are row key_leaf0 + l of the keys tensor.
struct KeyedTable {
  int word_offset[kMaxKeyedLeaves];
  int leaf_words[kMaxKeyedLeaves];
  int64_t size[kMaxKeyedLeaves];
  int key_leaf0;
  int n_leaves;
};

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

// B1 and B6 over columns [w_begin, w_end) of every client. s_stride is the
// distance between two lane blocks' scales: 1 for the per-block scales of
// B1, 0 for B6's single scale.
template <int BITS, Noise NOISE>
__global__ void __launch_bounds__(kThreads)
quantize_pack_buffer_kernel(const float* __restrict__ x,
                            const float* __restrict__ noise,
                            const int64_t* __restrict__ keys,
                            const float* __restrict__ sblk,
                            uint32_t* __restrict__ out, int W, int m,
                            int n_blocks, int s_stride, int w_begin,
                            int w_end, const KeyedTable t) {
  constexpr int PER = 32 / BITS;
  constexpr bool STOCHASTIC = NOISE != Noise::kNone;
  const int c = blockIdx.y;
  const int w = w_begin + kCols * (blockIdx.x * kThreads + threadIdx.x);
  if (w >= w_end) return;
  const float s = sblk[(static_cast<size_t>(c) * n_blocks + w / kLaneBlock)
                       * s_stride];
  uint32_t k1 = 0, k2 = 0, lw = 0, col = 0;
  int64_t size = 0;
  if (NOISE == Noise::kKeyed) {
    int lo = 0, hi = t.n_leaves - 1;   // largest l with word_offset[l] <= w
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.word_offset[mid] <= w) lo = mid; else hi = mid - 1;
    }
    const int64_t* key =
        keys + (static_cast<size_t>(t.key_leaf0 + lo) * m + c) * 2;
    k1 = static_cast<uint32_t>(key[0]);
    k2 = static_cast<uint32_t>(key[1]);
    lw = static_cast<uint32_t>(t.leaf_words[lo]);
    col = static_cast<uint32_t>(w - t.word_offset[lo]);
    size = t.size[lo];
  }
  const size_t base = static_cast<size_t>(c) * PER * W + w;
  uint32_t word[kCols] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const size_t at = base + static_cast<size_t>(i) * W;
    const float4 xv = *reinterpret_cast<const float4*>(x + at);
    const float xs[kCols] = {xv.x, xv.y, xv.z, xv.w};
    float us[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (NOISE == Noise::kTensor) {
      const float4 nv = *reinterpret_cast<const float4*>(noise + at);
      us[0] = nv.x; us[1] = nv.y; us[2] = nv.z; us[3] = nv.w;
    } else if (NOISE == Noise::kKeyed) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint64_t idx = static_cast<uint64_t>(i) * lw + col + j;
        if (static_cast<int64_t>(idx) < size)
          us[j] = threefry::uniform_at(k1, k2, idx);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      word[j] |= quantize_field<BITS, STOCHASTIC>(xs[j], s, us[j])
                 << (BITS * i);
  }
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(c) * W + w) =
      make_uint4(word[0], word[1], word[2], word[3]);
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

template <int BITS, Noise NOISE>
void launch(const float* x, const float* noise, const int64_t* keys,
            const float* sblk, uint32_t* out, int m, int W, int s_stride,
            int w_begin, int w_end, const KeyedTable& t,
            cudaStream_t stream) {
  const int cols = (w_end - w_begin) / kCols;
  const dim3 grid((cols + kThreads - 1) / kThreads, m);
  quantize_pack_buffer_kernel<BITS, NOISE><<<grid, kThreads, 0, stream>>>(
      x, noise, keys, sblk, out, W, m, W / kLaneBlock, s_stride, w_begin,
      w_end, t);
}

template <Noise NOISE>
int dispatch(const void* x, const void* noise, const void* keys,
             const void* sblk, void* out, int m, int W, int bits,
             int s_stride, int w_begin, int w_end, const KeyedTable& t,
             void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(noise);
  const int64_t* kf = static_cast<const int64_t*>(keys);
  const float* sf = static_cast<const float*>(sblk);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % kLaneBlock || w_begin % kLaneBlock || w_end % kLaneBlock ||
      w_begin < 0 || w_end > W || w_begin >= w_end)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: launch<2, NOISE>(xf, nf, kf, sf, o, m, W, s_stride, w_begin,
                             w_end, t, st); break;
    case 4: launch<4, NOISE>(xf, nf, kf, sf, o, m, W, s_stride, w_begin,
                             w_end, t, st); break;
    case 8: launch<8, NOISE>(xf, nf, kf, sf, o, m, W, s_stride, w_begin,
                             w_end, t, st); break;
    case 16: launch<16, NOISE>(xf, nf, kf, sf, o, m, W, s_stride, w_begin,
                               w_end, t, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// None or tensor noise over all W columns.
int dispatch_plain(const void* x, const void* noise, const void* sblk,
                   void* out, int m, int W, int bits, int s_stride,
                   int stochastic, void* stream) {
  KeyedTable t{};
  return stochastic
             ? dispatch<Noise::kTensor>(x, noise, nullptr, sblk, out, m, W,
                                        bits, s_stride, 0, W, t, stream)
             : dispatch<Noise::kNone>(x, nullptr, nullptr, sblk, out, m, W,
                                      bits, s_stride, 0, W, t, stream);
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

}  // namespace

// B1 with tensor noise or none. x, noise: f32 [m, 32/bits, W], 16-byte
// aligned; sblk: f32 [m, W/512]; out: u32 [m, W]. noise may be null when
// stochastic == 0. Returns cudaGetLastError().
extern "C" int quantize_pack_buffer(const void* x, const void* noise,
                                    const void* sblk, void* out, int m,
                                    int W, int bits, int stochastic,
                                    void* stream) {
  return dispatch_plain(x, noise, sblk, out, m, W, bits, 1, stochastic,
                        stream);
}

// B1 keyed, over all W columns. x: f32 [m, 32/bits, W], 16-byte aligned;
// keys: int64 [n_leaves, m, 2] on the device (the raw per-leaf keys); sblk:
// f32 [m, W/512]; out: u32 [m, W]. word_offset, leaf_words, sizes: host
// arrays [n_leaves], the layout's leaves (in order, contiguous from column
// 0 to W, each a multiple of 512 columns) and their real sizes. One launch
// per kMaxKeyedLeaves leaves, over their columns; *launches gets the number
// made. Returns cudaGetLastError() (or cudaErrorInvalidValue for a table
// that does not cover the W columns).
extern "C" int quantize_pack_buffer_keyed(
    const void* x, const void* keys, const void* sblk, void* out, int m,
    int W, int bits, const int32_t* word_offset, const int32_t* leaf_words,
    const int64_t* sizes, int n_leaves, void* stream, int* launches) {
  *launches = 0;
  if (n_leaves < 1 || word_offset[0] != 0 ||
      word_offset[n_leaves - 1] + leaf_words[n_leaves - 1] != W)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 1; l < n_leaves; ++l)
    if (word_offset[l] != word_offset[l - 1] + leaf_words[l - 1])
      return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < n_leaves; first += kMaxKeyedLeaves) {
    const int n = n_leaves - first < kMaxKeyedLeaves ? n_leaves - first
                                                     : kMaxKeyedLeaves;
    KeyedTable t{};
    for (int j = 0; j < n; ++j) {
      t.word_offset[j] = word_offset[first + j];
      t.leaf_words[j] = leaf_words[first + j];
      t.size[j] = sizes[first + j];
    }
    t.key_leaf0 = first;
    t.n_leaves = n;
    const int rc = dispatch<Noise::kKeyed>(
        x, nullptr, keys, sblk, out, m, W, bits, 1, t.word_offset[0],
        t.word_offset[n - 1] + t.leaf_words[n - 1], t, stream);
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

// B6. x, noise: f32 [32/bits, W], 16-byte aligned; s: f32 [1] (device);
// out: u32 [W]. noise may be null when stochastic == 0. Returns
// cudaGetLastError().
extern "C" int quantize_pack(const void* x, const void* noise, const void* s,
                             void* out, int W, int bits, int stochastic,
                             void* stream) {
  return dispatch_plain(x, noise, s, out, 1, W, bits, 0, stochastic,
                        stream);
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
