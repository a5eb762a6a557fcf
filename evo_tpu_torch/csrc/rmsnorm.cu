// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, fp32 statistics, output in
// the input type.
//
// Replaces: evo_tpu/ops/pallas_rmsnorm.py `_rmsnorm_kernel` (called through
// `rmsnorm_pallas`), which the JAX package runs only for >= 256 rows. Here
// every norm of the model goes through this kernel: 65 per forward pass
// and 65 per decode step of evo-1-8k-base.
//
// Bound on the card: bytes. Each element is read once and written once and
// does three flops, far below the H100's ~295 flops per byte of device
// memory. At (8192, 4096) bf16 it moves 134 MB: ~40 us at 3.35 TB/s.
//
// Design: one block per row. Threads read the row in 16-byte vectors
// (8 bf16), neighbouring threads on neighbouring addresses, and
// sum squares in fp32; a warp-shuffle reduction and one shared-memory step
// give the row's statistic. The second pass re-reads the row, which is at
// most a few KB and still in L1/L2, so device memory sees one read of x,
// one write of y, and the weight vector from L2.
//
// The gain is bf16 or float32 (a model whose param_dtype is float32 under
// bf16 activations): a template on its type, read as stored and upcast in
// registers, as the JAX kernel upcasts `w_ref` whatever its type. A bf16
// gain compiles to the same code as before the template.

#include <cstdint>

#include "common.cuh"

namespace {

// the 8 weights of 16-byte vector i of the activations, as float: one
// 16-byte load of bf16 weights, two of float32 ones (read as stored)
__device__ __forceinline__ void weights8(const __nv_bfloat16* w, int i,
                                         float* out) {
  const uint4 raw = reinterpret_cast<const uint4*>(w)[i];
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = evo::to_float(v[j]);
}

__device__ __forceinline__ void weights8(const float* w, int i, float* out) {
  const float4* v = reinterpret_cast<const float4*>(w) + 2 * i;
  const float4 a = v[0], b = v[1];
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
  out[4] = b.x;
  out[5] = b.y;
  out[6] = b.z;
  out[7] = b.w;
}

template <typename T, typename WT>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const WT* __restrict__ w, T* __restrict__ y,
                               int cols, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(VEC == 8, "weights8 reads 8 weights a vector");
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * cols);
  uint4* yr = reinterpret_cast<uint4*>(y + row * cols);
  const int nvec = cols / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xr[i];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = evo::to_float(v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float partial[32];
  __shared__ float inv_shared;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) inv_shared = rsqrtf(t / (float)cols + eps);
  }
  __syncthreads();
  const float inv = inv_shared;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xr[i];
    float wt[VEC];
    weights8(w, i, wt);
    uint4 out;
    const T* v = reinterpret_cast<const T*>(&raw);
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = evo::from_float<T>(evo::to_float(v[j]) * inv * wt[j]);
    yr[i] = out;
  }
}

template <typename T, typename WT>
int launch(const void* x, const void* w, void* y, int rows, int cols,
           float eps, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = cols / VEC;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  rmsnorm_kernel<T, WT><<<rows, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const WT*)w, (T*)y, cols, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, cols) contiguous bf16; w: (cols,) bf16; cols a multiple of
// 8; pointers 16-byte aligned.
extern "C" int evo_rmsnorm_bf16(const void* x, const void* w, void* y,
                                int rows, int cols, float eps, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, cols, eps,
                                              stream);
}

// the same with w (cols,) float32 (param_dtype float32 under bf16
// activations), read as stored; 16-byte aligned
extern "C" int evo_rmsnorm_bf16_wf32(const void* x, const void* w, void* y,
                                     int rows, int cols, float eps,
                                     void* stream) {
  return launch<__nv_bfloat16, float>(x, w, y, rows, cols, eps, stream);
}
