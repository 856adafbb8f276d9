// B3: fused heavy-ball update (paper eq. 4, velocity form).
//
// Replaces: momentum_sgd_pallas, src/repro/kernels/momentum_sgd.py:45
// (pallas_call at :63, body _momentum_kernel at :35).
//
// Computes, elementwise over n values with runtime f32 eta and theta:
//   v' = theta * v - eta * g ;  y' = y + v'
//
// Bound on the H100: bytes. Three reads and two writes of n f32; for one
// local step of the 2NN main path (16 clients x 199 210 params) ~64 MB,
// ~19 us at 3.35 TB/s, four steps a round.
//
// Design: flat, one thread per element over any contiguous tensor, so the
// Pallas kernel's (8, 512) padding and slicing are not needed; the wrapper
// launches once per parameter leaf. Each multiply and add is a separate
// _rn intrinsic, so nvcc cannot contract theta*v - eta*g into an FMA and
// the result is bitwise equal to the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void momentum_sgd_kernel(const float* __restrict__ y,
                                    const float* __restrict__ v,
                                    const float* __restrict__ g,
                                    float* __restrict__ y_out,
                                    float* __restrict__ v_out, int64_t n,
                                    float eta, float theta) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float vn = __fsub_rn(__fmul_rn(theta, v[i]), __fmul_rn(eta, g[i]));
  v_out[i] = vn;
  y_out[i] = __fadd_rn(y[i], vn);
}

}  // namespace

// y, v, g, y_out, v_out: f32 [n]. Returns cudaGetLastError().
extern "C" int momentum_sgd(const void* y, const void* v, const void* g,
                            void* y_out, void* v_out, int64_t n, float eta,
                            float theta, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  momentum_sgd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<float*>(y_out),
      static_cast<float*>(v_out), n, eta, theta);
  return static_cast<int>(cudaGetLastError());
}
