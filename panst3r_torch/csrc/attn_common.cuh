// What every kernel source of panst3r_torch/csrc shares: the masked logit,
// the f32 <-> bf16 conversions, the shared-memory opt-in and the error
// string entry of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace p3 {

constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Lets ``kern`` take ``bytes`` of dynamic shared memory (above 48 KB).
template <typename Kern>
inline cudaError_t prepare(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace p3

#define P3_ERROR_STRING_FN                                      \
  extern "C" const char* p3_error_string(int e) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));     \
  }
