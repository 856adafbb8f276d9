// A host stand-in for the pieces of the CUDA runtime and device library
// that the kernels in src/repro_torch/csrc use, so tests can compile those
// sources with a host C++ compiler and run them on the CPU
// (tests/test_torch_csrc_host.py). A launch `k<<<grid, block, smem,
// stream>>>(args)` is rewritten by the test into emu::launch, which runs
// every thread of every block in turn; that is faithful for kernels without
// shared memory or barriers, as these are. Rounding intrinsics map to plain
// IEEE float arithmetic (compile with -ffp-contract=off).
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<uint32_t>((v << (s & 31)) >> 32);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

namespace emu {
inline thread_local dim3 block_idx, thread_idx;
inline void launch(dim3 grid, dim3 block, int, cudaStream_t,
                   const std::function<void()>& body) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (unsigned tx = 0; tx < block.x; ++tx) {
        block_idx = dim3(bx, by);
        thread_idx = dim3(tx);
        body();
      }
}
}  // namespace emu
#define blockIdx emu::block_idx
#define threadIdx emu::thread_idx
