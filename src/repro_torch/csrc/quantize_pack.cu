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
// takes the busiest pipe at its peak rate. B4 keyed reads y, v, g and
// x_held and writes y', v' and the words, ~82.7 MB, ~24.7 us: bytes, since
// the same draws cost B1 ~12 us of ALU (chip_smoke.py counts B4's SASS the
// same way). B6 on one client's 2NN vector ([4, 50 176]) moves 1.8 MB,
// ~0.54 us, far below a launch.
//
// Design: B1, B4 and B6 run one body (encode_columns), one launch for all m
// clients, grid (column chunks, clients). Each thread packs 4 consecutive
// word columns: per planar row one 16-byte load of each input (x; B4: y, v,
// g and x_held; the noise in tensor mode) and one 16-byte store of each
// float output (B4: y', v'), then one 16-byte store of its 4 words;
// neighbouring threads hold neighbouring columns, so every access is
// coalesced. W is a multiple of 512, so rows stay 16-byte aligned and 4
// columns never straddle a lane block. The noise source is a template
// parameter: none (deterministic floor), tensor (a [m, per, W] f32 input,
// B6 and the parity tests) or keyed. Keyed, the kernel draws the
// stochastic-rounding noise itself: the wrapper passes the raw per-leaf keys
// [n_leaves, m, 2] (int64, truncated to u32 here) and the layout's leaf
// table (word offset, leaf words, size), which the C entry hands the kernel
// BY VALUE, 64 leaves a launch; position (c, i, w) of leaf l draws element
// i * leaf_words[l] + (w - word_offset[l]) of uniform(keys[l, c]) with
// threefry.cuh when that index is below size[l] (padding draws 0, and B4
// still steps it: its y, v and g are zero there). That is the noise the
// plain version is fed (WireLayout.noise_stacked), bit for bit, and a 13 MB
// input that is never written or read. A warp's 128 columns lie in one lane
// block, so the leaf and its key are uniform across the warp. The fields of
// a word are built in registers and stored once. Rounding is pinned with
// the _rn intrinsics so the words (and B4's y', v') are bitwise equal to
// the plain PyTorch version (IEEE division, no contraction of
// theta * v - eta * g into an FMA).
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kLaneBlock = 512;
constexpr int kThreads = 256;
constexpr int kCols = 4;          // word columns a thread packs
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

// Every operand of one encode, as the C entries gather them. x is the value
// B1 and B6 encode, or B4's held parameters x_held; y, v, g, y_out and
// v_out are B4's alone (null for B1 and B6). sblk
// holds one scale per (client, lane block); s_stride is the distance
// between two lane blocks' scales (0 for B6's single scale).
struct Operands {
  const float* x;
  const float* y;
  const float* v;
  const float* g;
  const float* noise;
  const int64_t* keys;
  const float* sblk;
  float* y_out;
  float* v_out;
  uint32_t* out;
  int m;
  int W;
  int s_stride;
  float eta;
  float theta;
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

__device__ __forceinline__ void unpack4(float4 a, float (&out)[kCols]) {
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// The encode of columns [w, w + 4) of client c, over columns [w_begin,
// w_end) of a launch. MOMENTUM (B4) first applies the penultimate step,
// v' = theta * v - eta * g ; y' = y + v', stores y' and v', and encodes
// y' - x_held. The pointers come in as __restrict__ parameters (not
// through Operands) so that the loads of every planar row can be issued
// ahead of B4's stores.
template <int BITS, Noise NOISE, bool MOMENTUM>
__device__ __forceinline__ void encode_columns(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ noise, const int64_t* __restrict__ keys,
    const float* __restrict__ sblk, float* __restrict__ y_out,
    float* __restrict__ v_out, uint32_t* __restrict__ out, int m, int W,
    int s_stride, float eta, float theta, int w_begin, int w_end,
    const KeyedTable& t) {
  constexpr int PER = 32 / BITS;
  constexpr bool STOCHASTIC = NOISE != Noise::kNone;
  const int c = blockIdx.y;
  const int w = w_begin + kCols * (blockIdx.x * kThreads + threadIdx.x);
  if (w >= w_end) return;
  const float s = sblk[(static_cast<size_t>(c) * (W / kLaneBlock)
                        + w / kLaneBlock) * s_stride];
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
    float xs[kCols];
    unpack4(*reinterpret_cast<const float4*>(x + at), xs);
    if (MOMENTUM) {
      float ys[kCols], vs[kCols], gs[kCols];
      unpack4(*reinterpret_cast<const float4*>(y + at), ys);
      unpack4(*reinterpret_cast<const float4*>(v + at), vs);
      unpack4(*reinterpret_cast<const float4*>(g + at), gs);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        vs[j] = __fsub_rn(__fmul_rn(theta, vs[j]), __fmul_rn(eta, gs[j]));
        ys[j] = __fadd_rn(ys[j], vs[j]);
        xs[j] = __fsub_rn(ys[j], xs[j]);
      }
      *reinterpret_cast<float4*>(v_out + at) =
          make_float4(vs[0], vs[1], vs[2], vs[3]);
      *reinterpret_cast<float4*>(y_out + at) =
          make_float4(ys[0], ys[1], ys[2], ys[3]);
    }
    float us[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (NOISE == Noise::kTensor) {
      unpack4(*reinterpret_cast<const float4*>(noise + at), us);
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

template <int BITS, Noise NOISE, bool MOMENTUM>
__device__ __forceinline__ void encode(const Operands& o, int w_begin,
                                       int w_end, const KeyedTable& t) {
  encode_columns<BITS, NOISE, MOMENTUM>(
      o.x, o.y, o.v, o.g, o.noise, o.keys, o.sblk, o.y_out, o.v_out, o.out,
      o.m, o.W, o.s_stride, o.eta, o.theta, w_begin, w_end, t);
}

// B1 and B6. The table is a __grid_constant__ parameter: the leaf search
// indexes it in place, without a copy to local memory.
template <int BITS, Noise NOISE>
__global__ void __launch_bounds__(kThreads)
quantize_pack_buffer_kernel(const Operands o, int w_begin, int w_end,
                            const __grid_constant__ KeyedTable t) {
  encode<BITS, NOISE, false>(o, w_begin, w_end, t);
}

// B4.
template <int BITS, Noise NOISE>
__global__ void __launch_bounds__(kThreads)
momentum_quantize_pack_buffer_kernel(const Operands o, int w_begin,
                                     int w_end,
                                     const __grid_constant__ KeyedTable t) {
  encode<BITS, NOISE, true>(o, w_begin, w_end, t);
}

template <int BITS, Noise NOISE, bool MOMENTUM>
void launch(const Operands& o, int w_begin, int w_end, const KeyedTable& t,
            cudaStream_t stream) {
  const int cols = (w_end - w_begin) / kCols;
  const dim3 grid((cols + kThreads - 1) / kThreads, o.m);
  if constexpr (MOMENTUM) {
    momentum_quantize_pack_buffer_kernel<BITS, NOISE>
        <<<grid, kThreads, 0, stream>>>(o, w_begin, w_end, t);
  } else {
    quantize_pack_buffer_kernel<BITS, NOISE>
        <<<grid, kThreads, 0, stream>>>(o, w_begin, w_end, t);
  }
}

// One launch over columns [w_begin, w_end) (multiples of 512 within W).
template <Noise NOISE, bool MOMENTUM>
int dispatch(const Operands& o, int bits, int w_begin, int w_end,
             const KeyedTable& t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (o.W % kLaneBlock || w_begin % kLaneBlock || w_end % kLaneBlock ||
      w_begin < 0 || w_end > o.W || w_begin >= w_end || o.m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: launch<2, NOISE, MOMENTUM>(o, w_begin, w_end, t, st); break;
    case 4: launch<4, NOISE, MOMENTUM>(o, w_begin, w_end, t, st); break;
    case 8: launch<8, NOISE, MOMENTUM>(o, w_begin, w_end, t, st); break;
    case 16: launch<16, NOISE, MOMENTUM>(o, w_begin, w_end, t, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// None or tensor noise over all W columns.
template <bool MOMENTUM>
int dispatch_plain(const Operands& o, int bits, int stochastic,
                   void* stream) {
  KeyedTable t{};
  return stochastic
             ? dispatch<Noise::kTensor, MOMENTUM>(o, bits, 0, o.W, t, stream)
             : dispatch<Noise::kNone, MOMENTUM>(o, bits, 0, o.W, t, stream);
}

// Keyed over all W columns: one launch per kMaxKeyedLeaves leaves of the
// table, over their columns; *launches gets the number made. The table
// must cover the W columns in order, each leaf right after the last.
template <bool MOMENTUM>
int dispatch_keyed(const Operands& o, int bits, const int32_t* word_offset,
                   const int32_t* leaf_words, const int64_t* sizes,
                   int n_leaves, void* stream, int* launches) {
  *launches = 0;
  if (n_leaves < 1 || word_offset[0] != 0 ||
      word_offset[n_leaves - 1] + leaf_words[n_leaves - 1] != o.W)
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
    const int rc = dispatch<Noise::kKeyed, MOMENTUM>(
        o, bits, t.word_offset[0],
        t.word_offset[n - 1] + t.leaf_words[n - 1], t, stream);
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

Operands encode_operands(const void* x, const void* noise, const void* keys,
                         const void* sblk, void* out, int m, int W,
                         int s_stride) {
  Operands o{};
  o.x = static_cast<const float*>(x);
  o.noise = static_cast<const float*>(noise);
  o.keys = static_cast<const int64_t*>(keys);
  o.sblk = static_cast<const float*>(sblk);
  o.out = static_cast<uint32_t*>(out);
  o.m = m;
  o.W = W;
  o.s_stride = s_stride;
  return o;
}

Operands momentum_operands(const void* y, const void* v, const void* g,
                           const void* x, const void* noise,
                           const void* keys, const void* sblk, void* y_out,
                           void* v_out, void* out, int m, int W, float eta,
                           float theta) {
  Operands o = encode_operands(x, noise, keys, sblk, out, m, W, 1);
  o.y = static_cast<const float*>(y);
  o.v = static_cast<const float*>(v);
  o.g = static_cast<const float*>(g);
  o.y_out = static_cast<float*>(y_out);
  o.v_out = static_cast<float*>(v_out);
  o.eta = eta;
  o.theta = theta;
  return o;
}

}  // namespace

// B1 with tensor noise or none. x, noise: f32 [m, 32/bits, W], 16-byte
// aligned; sblk: f32 [m, W/512]; out: u32 [m, W]. noise may be null when
// stochastic == 0. Returns cudaGetLastError().
extern "C" int quantize_pack_buffer(const void* x, const void* noise,
                                    const void* sblk, void* out, int m,
                                    int W, int bits, int stochastic,
                                    void* stream) {
  return dispatch_plain<false>(
      encode_operands(x, noise, nullptr, sblk, out, m, W, 1), bits,
      stochastic, stream);
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
  return dispatch_keyed<false>(
      encode_operands(x, nullptr, keys, sblk, out, m, W, 1), bits,
      word_offset, leaf_words, sizes, n_leaves, stream, launches);
}

// B6. x, noise: f32 [32/bits, W], 16-byte aligned; s: f32 [1] (device);
// out: u32 [W]. noise may be null when stochastic == 0. Returns
// cudaGetLastError().
extern "C" int quantize_pack(const void* x, const void* noise, const void* s,
                             void* out, int W, int bits, int stochastic,
                             void* stream) {
  return dispatch_plain<false>(
      encode_operands(x, noise, nullptr, s, out, 1, W, 0), bits, stochastic,
      stream);
}

// B4 with tensor noise or none. y, v, g, x, noise, y_out, v_out: f32
// [m, 32/bits, W], 16-byte aligned; sblk: f32 [m, W/512] (scales of the
// resulting delta); out: u32 [m, W]. noise may be null when stochastic ==
// 0. Returns cudaGetLastError().
extern "C" int momentum_quantize_pack_buffer(
    const void* y, const void* v, const void* g, const void* x,
    const void* noise, const void* sblk, void* y_out, void* v_out, void* out,
    int m, int W, int bits, float eta, float theta, int stochastic,
    void* stream) {
  return dispatch_plain<true>(
      momentum_operands(y, v, g, x, noise, nullptr, sblk, y_out, v_out, out,
                        m, W, eta, theta),
      bits, stochastic, stream);
}

// B4 keyed: the operands of B4 with the keys and leaf table of B1 keyed in
// place of the noise; one launch per kMaxKeyedLeaves leaves, *launches gets
// the number made. Returns cudaGetLastError() (or cudaErrorInvalidValue
// for a table that does not cover the W columns).
extern "C" int momentum_quantize_pack_buffer_keyed(
    const void* y, const void* v, const void* g, const void* x,
    const void* keys, const void* sblk, void* y_out, void* v_out, void* out,
    int m, int W, int bits, float eta, float theta,
    const int32_t* word_offset, const int32_t* leaf_words,
    const int64_t* sizes, int n_leaves, void* stream, int* launches) {
  return dispatch_keyed<true>(
      momentum_operands(y, v, g, x, nullptr, keys, sblk, y_out, v_out, out,
                        m, W, eta, theta),
      bits, word_offset, leaf_words, sizes, n_leaves, stream, launches);
}
