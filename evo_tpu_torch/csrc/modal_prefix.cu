// Decayed prefix over the K chunks of the chunked long conv: for complex
// per-chunk injected states inj[k], the per-(channel, state) decay
// a = p^chunk and an optional carried state s0 (zeros when absent),
//
//   incl[k] = a * incl[k-1] + inj[k]        (incl[-1] = s0)
//   ent[k]  = incl[k-1]                     the state entering chunk k
//   fin     = incl[K-1]                     the state after the last chunk
//
// so ent[k] = a^k s0 + (the zero-seeded prefix)[k-1] and fin = a^K s0 +
// (the zero-seeded prefix)[K-1], the terms a resumed segment adds.
//
// Replaces: evo_tpu/ops/pallas_prefix.py `_prefix_kernel` (called through
// `modal_prefix_pallas`, whose caller adds the a^k s0 terms outside): one
// launch per Hyena layer of a forward or resumed segment under
// `hyena_pallas_prefix`, 29 per forward of evo-1.
//
// Bound on the card: bytes. It reads 2 and writes 2 float32 values per
// (b, d, k, s) and does 8 flops on them: 67 MB at (1, 4096, 128, 8), about
// 20 us at 3.35 TB/s.
//
// Design: the TPU kernel runs Hillis-Steele doubling (log2 K shifted
// passes) because its lanes want whole vectors. Here one warp owns one
// (b, d): a lane owns 4 states (one 16-byte load of each of re and im a
// chunk; one state a lane when S % 4 != 0) and one segment of
// ceil(K / P) chunks, P = 32 / (lanes a chunk row), 16 segments at S = 8.
// A (b, d)'s (K, S) slab is contiguous, so the lanes read whole 32-byte
// sectors. Two-level scan: each lane runs the recurrence over its segment
// from zero (its loads requested four chunks ahead); the segments' end
// states are handed along the warp by shuffles, c_p = a^len c_{p-1} +
// e_{p-1} from c_0 = s0; then each lane walks its segment again from c_p,
// writing ent and, in the last segment, fin (the second read of inj finds
// it in L1 or L2). a = p^chunk and a^len come from (log|p|, arg p) inside
// the kernel, with the accurate expf and sincosf, in the plain version's
// order (the exponent times the log, then exp, cos and sin), so the
// wrapper launches nothing of its own. The serial walk and the doubling
// scheme sum in different orders: they agree to float32 rounding (a few
// 1e-6 of the state's size), not bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kAhead = 4;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// p^e from the pole's logs, as `_pole_pow_tables` computes it
__device__ __forceinline__ void pole_pow(float logmag, float theta, float e,
                                         float& re, float& im) {
  const float mag = expf(e * logmag);
  float sn, cs;
  sincosf(e * theta, &sn, &cs);
  re = mag * cs;
  im = mag * sn;
}

// One walk over chunks [k0, k1) of the lane's states from (sr, si); with
// `write`, ent[k] takes the state entering chunk k.
template <int VEC, bool kWrite>
__device__ __forceinline__ void walk(const float* __restrict__ ir,
                                     const float* __restrict__ ii,
                                     float* __restrict__ er,
                                     float* __restrict__ ei, int k0, int k1,
                                     int S, const float (&ar)[VEC],
                                     const float (&ai)[VEC], float (&sr)[VEC],
                                     float (&si)[VEC]) {
  for (int k = k0; k < k1; k += kAhead) {
    float vr[kAhead][VEC], vi[kAhead][VEC];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (k + j < k1) {
        load_vec<VEC>(ir + (int64_t)(k + j) * S, vr[j]);
        load_vec<VEC>(ii + (int64_t)(k + j) * S, vi[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (k + j < k1) {
        if (kWrite) {
          store_vec<VEC>(er + (int64_t)(k + j) * S, sr);
          store_vec<VEC>(ei + (int64_t)(k + j) * S, si);
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float nr = ar[v] * sr[v] - ai[v] * si[v] + vr[j][v];
          const float ni = ar[v] * si[v] + ai[v] * sr[v] + vi[j][v];
          sr[v] = nr;
          si[v] = ni;
        }
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    modal_prefix_kernel(const float* __restrict__ inj_r,
                        const float* __restrict__ inj_i,
                        const float* __restrict__ logmag,
                        const float* __restrict__ theta,
                        const float* __restrict__ s0,
                        float* __restrict__ ent_r, float* __restrict__ ent_i,
                        float* __restrict__ fin_r, float* __restrict__ fin_i,
                        int B, int D, int K, int S, int64_t sb, int64_t sd,
                        float chunk, int seg) {
  const int64_t bd = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bd >= (int64_t)B * D) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int b = (int)(bd / D), d = (int)(bd % D);
  const int R = S / VEC;     // lanes of one chunk row
  const int P = 32 / R;      // segments
  const int p = lane / R, s = (lane % R) * VEC;
  // lanes past P * R hold no segment but take part in the shuffles
  const int k0 = p < P ? min(K, p * seg) : K;
  const int k1 = p < P ? min(K, k0 + seg) : K;

  float ar[VEC], ai[VEC], Ar[VEC], Ai[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float lm = logmag[(int64_t)d * S + s + v];
    const float th = theta[(int64_t)d * S + s + v];
    pole_pow(lm, th, chunk, ar[v], ai[v]);
    pole_pow(lm, th, chunk * (float)seg, Ar[v], Ai[v]);
  }
  const int64_t off = (int64_t)b * sb + (int64_t)d * sd + s;
  const float* ir = inj_r + off;
  const float* ii = inj_i + off;

  // 1. each segment from zero
  float er[VEC], ei[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) er[v] = ei[v] = 0.f;
  walk<VEC, false>(ir, ii, nullptr, nullptr, k0, k1, S, ar, ai, er, ei);

  // 2. the state entering each segment, handed along in segment order
  float cr[VEC], ci[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int64_t at = (bd * S + s + v) * 2;
    cr[v] = s0 != nullptr ? s0[at] : 0.f;
    ci[v] = s0 != nullptr ? s0[at + 1] : 0.f;
  }
  for (int j = 0; j + 1 < P; ++j) {
    const int src = j * R + lane % R;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xr = __shfl_sync(0xffffffffu, er[v], src);
      const float xi = __shfl_sync(0xffffffffu, ei[v], src);
      const float nr = Ar[v] * cr[v] - Ai[v] * ci[v] + xr;
      const float ni = Ar[v] * ci[v] + Ai[v] * cr[v] + xi;
      if (p > j) {
        cr[v] = nr;
        ci[v] = ni;
      }
    }
  }

  // 3. the segment again from its entering state, writing ent
  walk<VEC, true>(ir, ii, ent_r + off, ent_i + off, k0, k1, S, ar, ai, cr,
                  ci);
  if (k0 < K && k1 == K) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      fin_r[bd * S + s + v] = cr[v];
      fin_i[bd * S + s + v] = ci[v];
    }
  }
}

}  // namespace

// inj_r, inj_i, ent_r, ent_i: (B, D, K, S) fp32 with strides (sb, sd, S,
// 1) in elements, one layout for all four; logmag, theta: (D, S) fp32;
// s0: (B, D, S, 2) fp32 (re, im) or null for zeros; fin_r, fin_i:
// (B, D, S) fp32; all but the four (B, D, K, S) arrays contiguous. S at
// most 32, or 128 when S % 4 == 0.
extern "C" int evo_modal_prefix_f32(const void* inj_r, const void* inj_i,
                                    const void* logmag, const void* theta,
                                    const void* s0, void* ent_r, void* ent_i,
                                    void* fin_r, void* fin_i, int B, int D,
                                    int K, int S, long long sb, long long sd,
                                    float chunk, void* stream) {
  const bool vec = S % 4 == 0 && sb % 4 == 0 && sd % 4 == 0 &&
                   (uintptr_t)inj_r % 16 == 0 && (uintptr_t)inj_i % 16 == 0 &&
                   (uintptr_t)ent_r % 16 == 0 && (uintptr_t)ent_i % 16 == 0;
  const int lanes = vec ? S / 4 : S;  // lanes of one chunk row
  if (S < 1 || lanes > 32 || K < 1) return (int)cudaErrorInvalidValue;
  const int P = 32 / lanes;
  const int seg = (K + P - 1) / P;
  const int64_t n = (int64_t)B * D;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  auto kernel = vec ? modal_prefix_kernel<4> : modal_prefix_kernel<1>;
  kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)inj_r, (const float*)inj_i, (const float*)logmag,
      (const float*)theta, (const float*)s0, (float*)ent_r, (float*)ent_i,
      (float*)fin_r, (float*)fin_i, B, D, K, S, (int64_t)sb, (int64_t)sd,
      chunk, seg);
  return (int)cudaGetLastError();
}
