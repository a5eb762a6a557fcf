// Shared helpers of the port's kernels: element conversion for bf16, the
// one activation type the kernels take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace evo {

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace evo
