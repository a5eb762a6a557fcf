// Decayed prefix over the K chunks of the chunked long conv: for complex
// per-chunk injected states inj[k] and the per-(channel, state) decay
// a = p^chunk,
//
//   incl[k] = a * incl[k-1] + inj[k]        (incl[-1] = 0)
//   ent[k]  = incl[k-1]                     the state entering chunk k
//   fin     = incl[K-1]                     the state after the last chunk
//
// Replaces: evo_tpu/ops/pallas_prefix.py `_prefix_kernel` (called through
// `modal_prefix_pallas`): one launch per Hyena layer of a forward under
// `hyena_pallas_prefix`, 29 per forward of evo-1.
//
// Bound on the card: bytes. It reads 2 and writes 2 float32 values per
// (b, d, k, s) and does 8 flops on them: 67 MB at (1, 4096, 128, 8), about
// 20 us at 3.35 TB/s.
//
// Design: the TPU kernel runs Hillis-Steele doubling (log2 K shifted
// passes) because its lanes want whole vectors; the sum it defines is a
// first-order recurrence, and here one thread walks the K chunks of one
// (b, d, s) with the state in two registers. The arrays arrive as
// (B, D, K, S) with S innermost, so the S threads of one (b, d) read and
// write one 4*S-byte run per chunk (one 32-byte sector at S = 8) and no
// transposed copy is made. The loads of eight chunks are requested before
// the dependent chain consumes them. A serial walk and the doubling
// scheme sum in different orders: they agree to float32 rounding (a few
// 1e-6 of the state's size), not bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
    modal_prefix_kernel(const float* __restrict__ inj_r,
                        const float* __restrict__ inj_i,
                        const float* __restrict__ a_r,
                        const float* __restrict__ a_i,
                        float* __restrict__ ent_r, float* __restrict__ ent_i,
                        float* __restrict__ fin_r, float* __restrict__ fin_i,
                        int64_t n, int D, int K, int S) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int s = (int)(idx % S);
  const int64_t bd = idx / S;
  const int d = (int)(bd % D);
  const float ar = a_r[(int64_t)d * S + s], ai = a_i[(int64_t)d * S + s];
  const int64_t base = bd * K * S + s;
  float sr = 0.f, si = 0.f;
  for (int k0 = 0; k0 < K; k0 += kAhead) {
    float vr[kAhead], vi[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool ok = k0 + j < K;
      vr[j] = ok ? inj_r[base + (int64_t)(k0 + j) * S] : 0.f;
      vi[j] = ok ? inj_i[base + (int64_t)(k0 + j) * S] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (k0 + j < K) {
        const int64_t o = base + (int64_t)(k0 + j) * S;
        ent_r[o] = sr;
        ent_i[o] = si;
        const float nr = ar * sr - ai * si + vr[j];
        const float ni = ar * si + ai * sr + vi[j];
        sr = nr;
        si = ni;
      }
    }
  }
  fin_r[idx] = sr;
  fin_i[idx] = si;
}

}  // namespace

// inj_r, inj_i, ent_r, ent_i: (B, D, K, S) fp32; a_r, a_i: (D, S) fp32;
// fin_r, fin_i: (B, D, S) fp32; all contiguous.
extern "C" int evo_modal_prefix_f32(const void* inj_r, const void* inj_i,
                                    const void* a_r, const void* a_i,
                                    void* ent_r, void* ent_i, void* fin_r,
                                    void* fin_i, int B, int D, int K, int S,
                                    void* stream) {
  const int64_t n = (int64_t)B * D * S;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  modal_prefix_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)inj_r, (const float*)inj_i, (const float*)a_r,
      (const float*)a_i, (float*)ent_r, (float*)ent_i, (float*)fin_r,
      (float*)fin_i, n, D, K, S);
  return (int)cudaGetLastError();
}
