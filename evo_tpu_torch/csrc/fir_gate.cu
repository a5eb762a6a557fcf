// Hyena FIR + gate: depthwise causal short FIR (K taps) plus bias over the
// three projected bf16 streams z (B, 3, C, L), each stream rounded to bf16,
// then x2 = stream 0 and u = stream 1 * stream 2. The K-1 samples before
// t = 0 are zeros for a fresh sequence, or the carried tail (B, 3, C, K-1)
// of the previous segment for a resumed one.
//
// Replaces: evo_tpu/ops/pallas_fir.py `_fir_gate_kernel` (called through
// `fir_gate_pallas`): one launch per Hyena layer at prefill and in scoring,
// 29 per forward pass or resumed segment of evo-1. (The JAX package leaves
// its kernel for `fir_causal_conv` when a tail is carried; here resumed
// segments stay on the kernel.)
//
// Bound on the card: bytes. It reads 3 values and writes 2 per (b, c, t)
// and does ~20 flops on them. At B=1, C=4096, L=8192 bf16 it moves 335 MB:
// ~100 us at 3.35 TB/s.
//
// Design: one thread per output position t; a block covers 256 positions
// of one (batch, channel) row, so a warp reads 32 neighbouring samples of
// each stream (coalesced, length is the contiguous axis). The two earlier
// samples each tap needs are the neighbours' samples, served from L1, and
// positions before 0 read as zero or from the carried tail, so there is no
// halo exchange and no ragged-edge padding. Numerics match the plain
// version bit for bit: taps and bias are summed in fp32 in the plain version's order with
// __fmul_rn/__fadd_rn (no FMA contraction), each stream is rounded to the
// activation type before the gate, and the gate multiplies the two rounded
// values in fp32 (exact for bf16 inputs) before rounding once more.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void fir_gate_kernel(const T* __restrict__ z,
                                const T* __restrict__ w,
                                const T* __restrict__ b,
                                const T* __restrict__ tail,
                                T* __restrict__ x2, T* __restrict__ u, int C,
                                int L, int K) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  const int64_t bi = blockIdx.z;
  if (t >= L) return;
  T rounded[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const T* zr = z + ((bi * 3 + s) * C + c) * (int64_t)L;
    const T* wr = w + ((int64_t)s * C + c) * K;
    const T* tr = tail == nullptr
                      ? nullptr
                      : tail + ((bi * 3 + s) * C + c) * (int64_t)(K - 1);
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const int src = t - (K - 1 - j);
      float zv = 0.f;
      if (src >= 0)
        zv = evo::to_float(zr[src]);
      else if (tr != nullptr)
        zv = evo::to_float(tr[K - 1 + src]);
      acc = __fadd_rn(acc, __fmul_rn(evo::to_float(wr[j]), zv));
    }
    if (b != nullptr) acc = __fadd_rn(acc, evo::to_float(b[s * C + c]));
    rounded[s] = evo::from_float<T>(acc);
  }
  const int64_t o = (bi * C + c) * (int64_t)L + t;
  x2[o] = rounded[0];
  u[o] = evo::from_float<T>(
      __fmul_rn(evo::to_float(rounded[1]), evo::to_float(rounded[2])));
}

template <typename T>
int launch(const void* z, const void* w, const void* b, const void* tail,
           void* x2, void* u, int B, int C, int L, int K, void* stream) {
  dim3 grid((L + kThreads - 1) / kThreads, C, B);
  fir_gate_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const T*)w, (const T*)b, (const T*)tail, (T*)x2, (T*)u, C,
      L, K);
  return (int)cudaGetLastError();
}

}  // namespace

// z: (B, 3, C, L), w: (3, C, K), b: (3, C) or null, tail: (B, 3, C, K-1) or
// null, x2/u: (B, C, L); all contiguous bf16.
extern "C" int evo_fir_gate_bf16(const void* z, const void* w, const void* b,
                                 const void* tail, void* x2, void* u, int B,
                                 int C, int L, int K, void* stream) {
  return launch<__nv_bfloat16>(z, w, b, tail, x2, u, B, C, L, K, stream);
}
