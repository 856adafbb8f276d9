// Threefry-2x32 (20 rounds) on the device, word for word the generator of
// repro_torch/prng.py (threefry2x32 and _bits_to_unit_float), which is
// bit-compatible with jax.random in its partitionable mode: element j of a
// draw hashes the counter pair (j >> 32, j & 0xffffffff) under the key, and
// the two output words are XORed into the draw's bits.
#pragma once

#include <stdint.h>

namespace threefry {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kOneF32Bits = 0x3F800000u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// Four rounds with rotations r0..r3 (one row of prng._ROT).
__device__ __forceinline__ void rounds(uint32_t& x1, uint32_t& x2, int r0,
                                       int r1, int r2, int r3) {
  x1 += x2; x2 = rotl(x2, r0) ^ x1;
  x1 += x2; x2 = rotl(x2, r1) ^ x1;
  x1 += x2; x2 = rotl(x2, r2) ^ x1;
  x1 += x2; x2 = rotl(x2, r3) ^ x1;
}

// The hash of counter words (x1, x2) under key words (k1, k2): both output
// words (prng.threefry2x32). jax.random.split keeps both as the new key.
__device__ __forceinline__ void hash2(uint32_t k1, uint32_t k2, uint32_t x1,
                                      uint32_t x2, uint32_t* y1,
                                      uint32_t* y2) {
  const uint32_t k3 = k1 ^ k2 ^ kParity;
  x1 += k1; x2 += k2;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k2; x2 += k3 + 1u;
  rounds(x1, x2, 17, 29, 16, 24); x1 += k3; x2 += k1 + 2u;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k1; x2 += k2 + 3u;
  rounds(x1, x2, 17, 29, 16, 24); x1 += k2; x2 += k3 + 4u;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k3; x2 += k1 + 5u;
  *y1 = x1;
  *y2 = x2;
}

// The XOR of the hash's two output words (prng.random_bits).
__device__ __forceinline__ uint32_t bits(uint32_t k1, uint32_t k2,
                                         uint32_t x1, uint32_t x2) {
  uint32_t y1, y2;
  hash2(k1, k2, x1, x2, &y1, &y2);
  return y1 ^ y2;
}

// Element `index` of jax.random.uniform(key, shape, float32) for any shape
// larger than index: the top 23 bits become the mantissa of a float in
// [1, 2), minus 1 (prng.uniform_at).
__device__ __forceinline__ float uniform_at(uint32_t k1, uint32_t k2,
                                            uint64_t index) {
  const uint32_t b = bits(k1, k2, static_cast<uint32_t>(index >> 32),
                          static_cast<uint32_t>(index));
  return __fsub_rn(__uint_as_float((b >> 9) | kOneF32Bits), 1.0f);
}

}  // namespace threefry
