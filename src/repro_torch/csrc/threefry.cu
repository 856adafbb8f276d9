// T1, T2, T3 and T4: the key chain's threefry draws, one launch each.
//
// Replaces: jax.random.split (T1), jax.random.uniform (T2, float32),
// jax.random.bits (T3, 32-bit; the sort keys of jax.random.permutation) and
// jax.random.normal (T4, float32; the event clock's durations) in
// jax_threefry_partitionable mode, which the JAX package switches on
// (src/repro/core/__init__.py) and leaves to XLA: no Pallas kernel computes
// them. Their plain versions are prng.split_plain, prng.uniform_plain,
// prng.random_bits_plain and prng.normal_plain, threefry written as int64
// tensor operations (~180 of them a draw), which on the card made ~700
// tiny kernels a round.
//
// T1 threefry_split: keys int64 [R, 2] (two uint32 words each) -> int64
// [R, num, 2]. Output pair (r, j) is the hash of the counter (j >> 32,
// j & 0xffffffff) under key r, both words kept. threefry_fold_in launches
// the same kernel for the one counter `data` (jax.random.fold_in), and
// threefry_fold_in_each folds a counter of its own into each key (data
// int64 [n] on the device, one key or n keys): the batched fold_in of the
// per-client data keys. One thread a pair. Bound on
// the H100: the launch. A round splits at most a few hundred keys (the
// per-leaf quantizer keys: n_leaves x m), a few KB and ~60 instructions a
// pair, far under the floor of one launch.
//
// T2 threefry_uniform: keys int64 [R, 2] -> f32 [R, n]. Element j of row r
// is uniform_at(key r, j) of threefry.cuh with a 64-bit j: the XOR of the
// hash's two words, its top 23 bits as the mantissa of a float in [1, 2),
// minus 1 (__fsub_rn: no contraction, bitwise with the plain version).
// Bound on the H100: operations. A draw is ~57 ALU instructions (20
// rounds of add, funnel shift and xor, the key schedule, the float) for 4
// bytes written, so at the dense quantized mixer's sizes the ALU pipe, not
// the 3.35 TB/s of memory, sets the least time, as in keyed B1. One
// thread a draw: block (x, y) serves kThreads consecutive draws of row y,
// so the row and its key are uniform across the block (no division by the
// row length) and the stores of a warp are 128 contiguous bytes.
//
// T3 threefry_bits: keys int64 [R, 2] -> int64 [R, n], element j of row r
// the XOR of the hash's two words of counter j (threefry::bits), widened
// to int64 in [0, 2^32): prng.random_bits_plain's layout, which torch.sort
// orders as jax orders the unsigned words. T2's body with the float
// conversion left out (Draw::kBits of their shared body); a draw writes
// 8 bytes. Bound on the H100 at the path's sizes (the sort keys of a
// permutation of 16): the launch.
//
// T4 threefry_normal: keys int64 [R, 2] -> f32 [R, n], jax 0.9's
// _normal_real: T2's draw f in [0, 1), then u = max(lo, f * 2 + lo) with lo
// = nextafter(-1, 0) (the uniform on [lo, 1): 1 - lo rounds to 2 in f32),
// then chlo.erf_inv's f32 polynomial (Giles: w = -log1p(-u * u), nine
// coefficients in w - 2.5 below 5, else in sqrt(w) - 3), times u, times
// sqrt(2). Every multiply and add is an _rn intrinsic, so nvcc contracts
// none of them into an FMA, and log1pf is the CUDA math library's, as in
// torch's log1p: bitwise with prng.normal_plain run on CUDA tensors (built
// without --use_fast_math). T2's grid and one thread a draw. Bound on the
// H100: the launch at the event clock's [16] draws; at large n the ALU
// and XU pipes (threefry, then log1pf, a square root and ~20 float
// operations) for 4 bytes written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2147483647;   // gridDim.x
constexpr int64_t kMaxRows = 65535;          // gridDim.y

// Output pair (r, j) hashes the counter first + j (first = 0: split; num
// = 1: fold_in of the uint32 `first`).
__global__ void __launch_bounds__(kThreads)
    threefry_split_kernel(const int64_t* __restrict__ keys, int64_t num,
                          int64_t first, int64_t total,
                          int64_t* __restrict__ out) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / num;
  const uint64_t j = static_cast<uint64_t>(first + i - r * num);
  uint32_t y1, y2;
  threefry::hash2(static_cast<uint32_t>(keys[2 * r]),
                  static_cast<uint32_t>(keys[2 * r + 1]),
                  static_cast<uint32_t>(j >> 32), static_cast<uint32_t>(j),
                  &y1, &y2);
  out[2 * i] = static_cast<int64_t>(y1);
  out[2 * i + 1] = static_cast<int64_t>(y2);
}

// Output pair i hashes the counter (0, data[i] mod 2^32) under key
// i * key_step (key_step 0: one key for every counter; 1: a key each).
__global__ void __launch_bounds__(kThreads)
    threefry_fold_in_each_kernel(const int64_t* __restrict__ keys,
                                 int64_t key_step,
                                 const int64_t* __restrict__ data, int64_t n,
                                 int64_t* __restrict__ out) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = i * key_step;
  uint32_t y1, y2;
  threefry::hash2(static_cast<uint32_t>(keys[2 * r]),
                  static_cast<uint32_t>(keys[2 * r + 1]), 0u,
                  static_cast<uint32_t>(data[i]), &y1, &y2);
  out[2 * i] = static_cast<int64_t>(y1);
  out[2 * i + 1] = static_cast<int64_t>(y2);
}

enum class Draw { kUniform, kBits, kNormal };

// chlo.erf_inv's coefficients, highest power first (prng._ERFINV_W_LT_5,
// prng._ERFINV_W_GE_5).
__constant__ float kErfInvLt5[9] = {
    2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
    0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
    1.50140941f};
__constant__ float kErfInvGe5[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
    0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
    2.83297682f};

// Element `index` of jax.random.normal(key, shape, float32)
// (prng.normal_plain, operation for operation).
__device__ __forceinline__ float normal_at(uint32_t k1, uint32_t k2,
                                           uint64_t index) {
  const float lo = -0.99999994f;   // nextafter(-1, 0)
  const float f = threefry::uniform_at(k1, k2, index);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
  float w = -log1pf(__fmul_rn(u, -u));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  const float* c = small ? kErfInvLt5 : kErfInvGe5;
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(c[i], __fmul_rn(p, w));
  return __fmul_rn(__fmul_rn(p, u), 1.41421354f);   // f32(sqrt(2))
}

// One draw of T2 (the f32 uniform), T3 (the raw 32 bits as int64) or T4
// (the f32 normal): element j of row r.
template <Draw KIND, typename Out>
__device__ __forceinline__ void draw(const int64_t* __restrict__ keys,
                                     int64_t n, Out* __restrict__ out) {
  const int64_t r = blockIdx.y;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k2 = static_cast<uint32_t>(keys[2 * r + 1]);
  const uint64_t idx = static_cast<uint64_t>(j);
  if constexpr (KIND == Draw::kBits) {
    out[r * n + j] = static_cast<int64_t>(threefry::bits(
        k1, k2, static_cast<uint32_t>(idx >> 32), static_cast<uint32_t>(idx)));
  } else if constexpr (KIND == Draw::kNormal) {
    out[r * n + j] = normal_at(k1, k2, idx);
  } else {
    out[r * n + j] = threefry::uniform_at(k1, k2, idx);
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry_uniform_kernel(const int64_t* __restrict__ keys, int64_t n,
                            float* __restrict__ out) {
  draw<Draw::kUniform>(keys, n, out);
}

__global__ void __launch_bounds__(kThreads)
    threefry_bits_kernel(const int64_t* __restrict__ keys, int64_t n,
                         int64_t* __restrict__ out) {
  draw<Draw::kBits>(keys, n, out);
}

__global__ void __launch_bounds__(kThreads)
    threefry_normal_kernel(const int64_t* __restrict__ keys, int64_t n,
                           float* __restrict__ out) {
  draw<Draw::kNormal>(keys, n, out);
}

// Launches T2, T3 or T4 over a grid of (blocks of a row, rows); see
// threefry_uniform.
template <Draw KIND>
int launch_draw(const void* keys, int64_t rows, int64_t n, void* out,
                void* stream) {
  if (rows <= 0 || n <= 0 || rows > kMaxRows) return cudaErrorInvalidValue;
  const int64_t per_row = (n + kThreads - 1) / kThreads;
  if (per_row > kMaxBlocks) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(per_row),
                  static_cast<unsigned>(rows));
  const auto* k = static_cast<const int64_t*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (KIND == Draw::kBits) {
    threefry_bits_kernel<<<grid, kThreads, 0, s>>>(
        k, n, static_cast<int64_t*>(out));
  } else if constexpr (KIND == Draw::kNormal) {
    threefry_normal_kernel<<<grid, kThreads, 0, s>>>(
        k, n, static_cast<float*>(out));
  } else {
    threefry_uniform_kernel<<<grid, kThreads, 0, s>>>(
        k, n, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// T1. keys: int64 [rows, 2] on the device; out: int64 [rows, num, 2].
// rows and num must be positive. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a count that is not positive or a grid too
// large for one launch).
extern "C" int threefry_split(const void* keys, int64_t rows, int64_t num,
                              void* out, void* stream) {
  if (rows <= 0 || num <= 0 || rows > INT64_MAX / num) {
    return cudaErrorInvalidValue;
  }
  const int64_t total = rows * num;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  threefry_split_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), num, 0, total,
      static_cast<int64_t*>(out));
  return cudaGetLastError();
}

// T1 as jax.random.fold_in(key, data) for a uint32 data: keys int64 [rows,
// 2] -> int64 [rows, 2], the hash of the counter (0, data) with both words
// kept (split(key, data + 1)[data] without the other data pairs). Returns
// cudaGetLastError() (or cudaErrorInvalidValue for rows not positive or
// data outside [0, 2^32)).
extern "C" int threefry_fold_in(const void* keys, int64_t rows, int64_t data,
                                void* out, void* stream) {
  if (rows <= 0 || data < 0 || data > 0xffffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  threefry_split_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), 1, data, rows,
      static_cast<int64_t*>(out));
  return cudaGetLastError();
}

// T1 as jax.random.fold_in over a vector of data, one launch: keys int64
// [key_rows, 2] (key_rows 1, or n: a key a counter), data int64 [n] (each
// taken modulo 2^32, as jax converts fold_in's data to uint32) -> out int64
// [n, 2]. Returns cudaGetLastError() (or cudaErrorInvalidValue for n not
// positive or key_rows neither 1 nor n).
extern "C" int threefry_fold_in_each(const void* keys, int64_t key_rows,
                                     const void* data, int64_t n, void* out,
                                     void* stream) {
  if (n <= 0 || (key_rows != 1 && key_rows != n)) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  threefry_fold_in_each_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), key_rows == 1 ? 0 : 1,
      static_cast<const int64_t*>(data), n, static_cast<int64_t*>(out));
  return cudaGetLastError();
}

// T2. keys: int64 [rows, 2] on the device; out: f32 [rows, n]. rows and n
// must be positive. Returns cudaGetLastError() (or cudaErrorInvalidValue
// for a count that is not positive or a grid too large for one launch:
// more than 65 535 rows, or a row of more than 2^31 - 1 blocks).
extern "C" int threefry_uniform(const void* keys, int64_t rows, int64_t n,
                                void* out, void* stream) {
  return launch_draw<Draw::kUniform>(keys, rows, n, out, stream);
}

// T3. keys: int64 [rows, 2] on the device; out: int64 [rows, n], values in
// [0, 2^32). The same checks and return codes as threefry_uniform.
extern "C" int threefry_bits(const void* keys, int64_t rows, int64_t n,
                             void* out, void* stream) {
  return launch_draw<Draw::kBits>(keys, rows, n, out, stream);
}

// T4. keys: int64 [rows, 2] on the device; out: f32 [rows, n]. The same
// checks and return codes as threefry_uniform.
extern "C" int threefry_normal(const void* keys, int64_t rows, int64_t n,
                               void* out, void* stream) {
  return launch_draw<Draw::kNormal>(keys, rows, n, out, stream);
}
