// T1, T2 and T3: the key chain's threefry draws, one launch each.
//
// Replaces: jax.random.split (T1), jax.random.uniform (T2, float32) and
// jax.random.bits (T3, 32-bit; the sort keys of jax.random.permutation) in
// jax_threefry_partitionable mode, which the JAX package switches on
// (src/repro/core/__init__.py) and leaves to XLA: no Pallas kernel computes
// them. Their plain versions are prng.split_plain, prng.uniform_plain and
// prng.random_bits_plain, threefry written as int64 tensor operations
// (~180 of them a draw), which on the card made ~700 tiny kernels a round.
//
// T1 threefry_split: keys int64 [R, 2] (two uint32 words each) -> int64
// [R, num, 2]. Output pair (r, j) is the hash of the counter (j >> 32,
// j & 0xffffffff) under key r, both words kept. One thread a pair. Bound on
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
// conversion left out (the BITS flag of their shared body); a draw writes
// 8 bytes. Bound on the H100 at the path's sizes (the sort keys of a
// permutation of 16): the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2147483647;   // gridDim.x
constexpr int64_t kMaxRows = 65535;          // gridDim.y

__global__ void __launch_bounds__(kThreads)
    threefry_split_kernel(const int64_t* __restrict__ keys, int64_t num,
                          int64_t total, int64_t* __restrict__ out) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / num;
  const uint64_t j = static_cast<uint64_t>(i - r * num);
  uint32_t y1, y2;
  threefry::hash2(static_cast<uint32_t>(keys[2 * r]),
                  static_cast<uint32_t>(keys[2 * r + 1]),
                  static_cast<uint32_t>(j >> 32), static_cast<uint32_t>(j),
                  &y1, &y2);
  out[2 * i] = static_cast<int64_t>(y1);
  out[2 * i + 1] = static_cast<int64_t>(y2);
}

// One draw of T2 (BITS = false: the f32 uniform) or T3 (BITS = true: the
// raw 32 bits as int64): element j of row r.
template <bool BITS, typename Out>
__device__ __forceinline__ void draw(const int64_t* __restrict__ keys,
                                     int64_t n, Out* __restrict__ out) {
  const int64_t r = blockIdx.y;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k2 = static_cast<uint32_t>(keys[2 * r + 1]);
  const uint64_t idx = static_cast<uint64_t>(j);
  if constexpr (BITS) {
    out[r * n + j] = static_cast<int64_t>(threefry::bits(
        k1, k2, static_cast<uint32_t>(idx >> 32), static_cast<uint32_t>(idx)));
  } else {
    out[r * n + j] = threefry::uniform_at(k1, k2, idx);
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry_uniform_kernel(const int64_t* __restrict__ keys, int64_t n,
                            float* __restrict__ out) {
  draw<false>(keys, n, out);
}

__global__ void __launch_bounds__(kThreads)
    threefry_bits_kernel(const int64_t* __restrict__ keys, int64_t n,
                         int64_t* __restrict__ out) {
  draw<true>(keys, n, out);
}

// Launches T2 or T3 over a grid of (blocks of a row, rows); see
// threefry_uniform.
template <bool BITS>
int launch_draw(const void* keys, int64_t rows, int64_t n, void* out,
                void* stream) {
  if (rows <= 0 || n <= 0 || rows > kMaxRows) return cudaErrorInvalidValue;
  const int64_t per_row = (n + kThreads - 1) / kThreads;
  if (per_row > kMaxBlocks) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(per_row),
                  static_cast<unsigned>(rows));
  const auto* k = static_cast<const int64_t*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (BITS) {
    threefry_bits_kernel<<<grid, kThreads, 0, s>>>(
        k, n, static_cast<int64_t*>(out));
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
      static_cast<const int64_t*>(keys), num, total,
      static_cast<int64_t*>(out));
  return cudaGetLastError();
}

// T2. keys: int64 [rows, 2] on the device; out: f32 [rows, n]. rows and n
// must be positive. Returns cudaGetLastError() (or cudaErrorInvalidValue
// for a count that is not positive or a grid too large for one launch:
// more than 65 535 rows, or a row of more than 2^31 - 1 blocks).
extern "C" int threefry_uniform(const void* keys, int64_t rows, int64_t n,
                                void* out, void* stream) {
  return launch_draw<false>(keys, rows, n, out, stream);
}

// T3. keys: int64 [rows, 2] on the device; out: int64 [rows, n], values in
// [0, 2^32). The same checks and return codes as threefry_uniform.
extern "C" int threefry_bits(const void* keys, int64_t rows, int64_t n,
                             void* out, void* stream) {
  return launch_draw<true>(keys, rows, n, out, stream);
}
