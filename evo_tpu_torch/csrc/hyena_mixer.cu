// The Hyena mixer between its two projections, in one pass over z:
//
//   z' = depthwise causal FIR(z) + bias, each stream rounded to bf16
//   x2, x1, v = z';  u = x1 * v                      (bf16)
//   y  = chunked long conv(u) + d_skip * u           (float32, see below)
//   out = x2 * bf16(y)                               (bf16)
//
// and the modal state after the last position. The long conv has the
// modal filter h[t] = Re(sum_s R_s p_s^t). Per chunk of Ct positions:
//   y_local = T u      T the lower-triangular Toeplitz of h[0..Ct), with
//                      d_skip on its diagonal
//   y_state[t] = Re(sum_s ent_s * R_s p_s^(t+1))   ent: the state entering
//   inj_s   = sum_c p_s^(Ct-1-c) u[c]
//   state entering the next chunk = p^Ct * ent + inj
//
// Replaces: evo_tpu/ops/pallas_hyena.py `_mixer_kernel` (called through
// `hyena_mixer_pallas`): one launch per Hyena layer of a forward or a
// resumed segment under `hyena_fused_mixer`, 29 per forward of evo-1.
//
// Bound on the card: bytes, narrowly. At z (1, 3, 4096, 8192) bf16 it
// reads 201 MB and writes 67 MB (0.080 ms at 3.35 TB/s). The function
// needs 5.1 GFLOP of float32 (0.076 ms at 67 TFLOP/s): per chunk of 64 the
// lower triangle of the Toeplitz product, 64 * 65, and 4,096 for injection
// and decay, and 23 a position for the FIR and the gates. This kernel runs
// the Toeplitz product dense over zero-padded taps, about twice the
// triangle: its own choice, not the function's need. The products have to
// be full float32: a single bf16 pass is 1e-3 off, TF32 keeps 10 bits, and
// the tensor cores have no float32 mma, so they run as FFMA.
//
// Design: one warp owns one (batch, channel) row and walks its chunks in
// order, so no result depends on how blocks are scheduled. Lane l owns
// positions 2l and 2l + 1 of every chunk (Ct <= 64). Nothing of the TPU
// kernel's tables crosses device memory: each lane computes the powers of
// the channel's poles that its two positions need (p^t, R p^(t+1),
// p^(Ct-1-t), and p^Ct) once, by binary exponentiation from six squarings
// (a few float32 roundings each), and keeps them in registers; the Ct taps
// go to shared memory behind a run of zeros, so the Toeplitz product needs
// no triangle test. Per chunk a lane reads its 3 x 2 samples (the next
// chunk's are requested before this one is computed), the FIR window comes
// from a small shared-memory row that carries the previous chunk's tail
// (or the carried tail of a resumed segment), u goes to shared memory and
// the Toeplitz sum runs over it with one 8-byte tap load per four FMAs
// and two partial sums an output; the injected state is a warp sum of
// each lane's two terms (a reduce-scatter and 16 broadcasts), and the
// modal state lives replicated in every lane's registers, advanced by
// state = p^Ct * state + inj (a serial carry: the contribution of the
// carried state is never formed as an explicit high power). The chunk of
// 64 is also compiled in as a constant, so its loops unroll. The kernel
// is bound by latency, not by instruction slots or bytes: its registers
// leave 12 warps an SM, each a chain of dependent steps per chunk. The FIR
// repeats the plain version's float32 order without FMA contraction, as
// the FIR + gate kernel does. The sums of the long conv are ordered
// differently from the plain version's einsums, so y agrees to float32
// rounding before it is rounded to bf16, and an output may land one bf16
// step away.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxChunk = 64;  // two positions a lane
constexpr int kMaxS = 8;       // modal states a channel
constexpr int kTaps = 3;       // FIR length: every published config's
constexpr int kWarps = 4;
constexpr int kSquares = 7;    // p^(2^j), j < 7: exponents up to 127

constexpr int kTap0 = kMaxChunk - 1;  // hs[kTap0 + j] = h[j]: odd, so that
                                      // the pair {h[t-1], h[t]} of an even
                                      // t is one aligned 8-byte load

struct WarpScratch {
  __align__(16) float hs[2 * kMaxChunk];  // zeros below kTap0 and past h
  __align__(16) float us[kMaxChunk];      // u of the current chunk
  float zs[3][kMaxChunk + kTaps];         // raw z behind its kTaps - 1 tail
};

// (r, i) = p^e from the squares q[j] = p^(2^j); e < 2^kSquares
__device__ __forceinline__ void cpow(const float* qr, const float* qi, int e,
                                     float* r, float* i) {
  float ar = 1.f, ai = 0.f;
#pragma unroll
  for (int j = 0; j < kSquares; ++j) {
    if ((e >> j) & 1) {
      const float nr = ar * qr[j] - ai * qi[j];
      const float ni = ar * qi[j] + ai * qr[j];
      ar = nr;
      ai = ni;
    }
  }
  *r = ar;
  *i = ai;
}

// Sums of v[0..16) over the 32 lanes, in every lane: a reduce-scatter (each
// step a lane keeps one half of its values and sends the other to the lane
// that keeps that half: 8 + 4 + 2 + 1 shuffles), one more exchange between
// lane pairs, and 16 broadcasts, in place of 16 x 5 butterfly steps. Every
// lane ends with the same bits, since each sum is formed once.
template <int HALF>
__device__ __forceinline__ void scatter_step(float* v, int lane) {
  const bool up = (lane & (2 * HALF)) != 0;  // lane bits 4, 3, 2, 1
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? v[j] : v[j + HALF];
    const float keep = up ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

__device__ __forceinline__ void warp_sum16(float* v, int lane) {
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  // v[0] is now value (lane >> 1) & 15 summed over the 16 lanes of this
  // lane's parity; add the other parity
  const float total = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = __shfl_sync(0xffffffffu, total, 2 * k);
}

// CT: the chunk as a compile-time constant (the trip counts and the range
// tests of the common chunk of 64 fold away), or 0 for a chunk given at run
// time.
template <int CT>
__global__ void __launch_bounds__(kWarps * 32)
    hyena_mixer_kernel(const __nv_bfloat16* __restrict__ z,
                       const float* __restrict__ fir_w,
                       const float* __restrict__ fir_b,
                       const float* __restrict__ poles,
                       const float* __restrict__ residues,
                       const float* __restrict__ d_skip,
                       const __nv_bfloat16* __restrict__ fir0,
                       const float* __restrict__ st0,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ iir, int64_t rows, int C,
                       int64_t L, int ct, int S, int vec) {
  static_assert(kMaxS == 8, "warp_sum16 takes 8 complex states");
  const int Ct = CT > 0 ? CT : ct;
  __shared__ WarpScratch scratch[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;  // b * C + c
  if (row >= rows) return;  // whole warps leave; only __syncwarp below
  WarpScratch& sm = scratch[warp];
  const int64_t bi = row / C;
  const int c = (int)(row % C);
  const int t0 = 2 * lane, t1 = t0 + 1;
  const bool in0 = CT == kMaxChunk || t0 < Ct;
  const bool in1 = CT == kMaxChunk || t1 < Ct;

  // ---- per-channel constants, in registers ----
  float tabr[kMaxS][2], tabi[kMaxS][2];  // R p^(t+1)
  float pwr[kMaxS][2], pwi[kMaxS][2];    // p^(Ct-1-t)
  float ar[kMaxS], ai[kMaxS];            // p^Ct
  float sr[kMaxS], si[kMaxS];            // the modal state, in every lane
  float h0 = 0.f, h1 = 0.f;              // taps h[t0], h[t1]
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    float pr = 0.f, pi = 0.f, rr = 0.f, ri = 0.f;
    sr[s] = si[s] = 0.f;
    if (s < S) {
      const int64_t o = ((int64_t)c * S + s) * 2;
      pr = poles[o];
      pi = poles[o + 1];
      rr = residues[o];
      ri = residues[o + 1];
      if (st0 != nullptr) {
        sr[s] = st0[(row * S + s) * 2];
        si[s] = st0[(row * S + s) * 2 + 1];
      }
    }
    float qr[kSquares], qi[kSquares];
    qr[0] = pr;
    qi[0] = pi;
#pragma unroll
    for (int j = 1; j < kSquares; ++j) {
      qr[j] = qr[j - 1] * qr[j - 1] - qi[j - 1] * qi[j - 1];
      qi[j] = 2.f * qr[j - 1] * qi[j - 1];
    }
    float er, ei;  // p^t0, then p^t1, then p^(t1+1)
    cpow(qr, qi, t0, &er, &ei);
    h0 += rr * er - ri * ei;
    float nr = er * pr - ei * pi, ni = er * pi + ei * pr;
    h1 += rr * nr - ri * ni;
    tabr[s][0] = rr * nr - ri * ni;
    tabi[s][0] = rr * ni + ri * nr;
    er = nr * pr - ni * pi;
    ei = nr * pi + ni * pr;
    tabr[s][1] = rr * er - ri * ei;
    tabi[s][1] = rr * ei + ri * er;
    pwr[s][0] = pwi[s][0] = pwr[s][1] = pwi[s][1] = 0.f;
    if (in1) {
      cpow(qr, qi, Ct - 1 - t1, &er, &ei);
      pwr[s][1] = er;
      pwi[s][1] = ei;
      pwr[s][0] = er * pr - ei * pi;
      pwi[s][0] = er * pi + ei * pr;
    } else if (in0) {  // t0 is the chunk's last position: p^0
      pwr[s][0] = 1.f;
    }
    cpow(qr, qi, Ct, &ar[s], &ai[s]);
  }
  float w[3][kTaps], bias[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      w[s][j] = fir_w[((int64_t)s * C + c) * kTaps + j];
    bias[s] = fir_b == nullptr ? 0.f : fir_b[(int64_t)s * C + c];
  }

  for (int i = lane; i < 2 * kMaxChunk; i += 32) sm.hs[i] = 0.f;
  __syncwarp();
  if (in0) sm.hs[kTap0 + t0] = t0 == 0 ? h0 + d_skip[c] : h0;
  if (in1) sm.hs[kTap0 + t1] = h1;
  if (lane < kTaps - 1) {
#pragma unroll
    for (int s = 0; s < 3; ++s)
      sm.zs[s][lane] =
          fir0 == nullptr
              ? 0.f
              : evo::to_float(fir0[((bi * 3 + s) * C + c) *
                                       (int64_t)(kTaps - 1) +
                                   lane]);
  }

  const __nv_bfloat16* zrow[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) zrow[s] = z + ((bi * 3 + s) * C + c) * L;
  __nv_bfloat16* yrow = y + row * L;
  const int64_t K = L / Ct;

  auto fetch = [&](int64_t q, float (*dst)[2]) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const __nv_bfloat16* p = zrow[s] + q * Ct + t0;
      dst[s][0] = dst[s][1] = 0.f;
      if (vec) {
        if (in0) {
          const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(p);
          dst[s][0] = __low2float(v2);
          dst[s][1] = __high2float(v2);
        }
      } else {
        if (in0) dst[s][0] = evo::to_float(p[0]);
        if (in1) dst[s][1] = evo::to_float(p[1]);
      }
    }
  };

  float cur[3][2], nxt[3][2];
  fetch(0, cur);
  for (int64_t q = 0; q < K; ++q) {
    if (q + 1 < K) fetch(q + 1, nxt);
    // the previous chunk's readers of zs and us are done (a __syncwarp
    // ends every iteration)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (in0) sm.zs[s][kTaps - 1 + t0] = cur[s][0];
      if (in1) sm.zs[s][kTaps - 1 + t1] = cur[s][1];
    }
    __syncwarp();

    // ---- FIR + bias in the plain version's order, rounded, then gated ----
    float f[3][2];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float win[kTaps + 1];  // raw z at positions t0 - (kTaps-1) .. t1
#pragma unroll
      for (int j = 0; j <= kTaps; ++j) win[j] = sm.zs[s][t0 + j];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          acc = __fadd_rn(acc, __fmul_rn(w[s][j], win[k + j]));
        if (fir_b != nullptr) acc = __fadd_rn(acc, bias[s]);
        f[s][k] = evo::to_float(__float2bfloat16_rn(acc));
      }
    }
    float u0 = evo::to_float(__float2bfloat16_rn(__fmul_rn(f[1][0], f[2][0])));
    float u1 = evo::to_float(__float2bfloat16_rn(__fmul_rn(f[1][1], f[2][1])));
    if (!in0) u0 = 0.f;
    if (!in1) u1 = 0.f;
    *reinterpret_cast<float2*>(&sm.us[t0]) = make_float2(u0, u1);
    __syncwarp();
    // the tail for the next chunk's FIR: this chunk's last kTaps - 1 samples
    if (q + 1 < K && lane < kTaps - 1) {
#pragma unroll
      for (int s = 0; s < 3; ++s) sm.zs[s][lane] = sm.zs[s][Ct + lane];
    }

    // ---- y_local = T u: taps h[t - c], zeros where t < c. Two columns a
    // step: {h[t0-c-1], h[t0-c]} is one 8-byte load (t0 and c even), and
    // h[t1-c] = h[t0-(c-1)] is the previous step's value. Two partial sums
    // an output keep the FMA chains short. ----
    float ya[2] = {0.f, 0.f}, yb[2] = {0.f, 0.f};  // t0, t1: even, odd c
    {
      const float* hp = &sm.hs[kTap0 + t0];  // hp[-c] = h[t0 - c]
      float hprev = hp[1];                   // h[t1 - 0]
      auto pair = [&](float ue, float uo, int cc) {
        const float2 h2 = *reinterpret_cast<const float2*>(hp - cc - 1);
        ya[0] = fmaf(h2.y, ue, ya[0]);   // h[t0 - cc]
        ya[1] = fmaf(hprev, ue, ya[1]);  // h[t1 - cc]
        yb[0] = fmaf(h2.x, uo, yb[0]);   // h[t0 - cc - 1]
        yb[1] = fmaf(h2.y, uo, yb[1]);   // h[t1 - cc - 1]
        hprev = h2.x;
      };
      if (CT > 0) {
        static_assert(CT % 4 == 0, "a compile-time chunk is a multiple of 4");
#pragma unroll
        for (int cc = 0; cc < CT; cc += 4) {
          const float4 u4 = *reinterpret_cast<const float4*>(&sm.us[cc]);
          pair(u4.x, u4.y, cc);
          pair(u4.z, u4.w, cc + 2);
        }
      } else {
        int cc = 0;
        for (; cc + 2 <= Ct; cc += 2) pair(sm.us[cc], sm.us[cc + 1], cc);
        if (cc < Ct) {
          const float uc = sm.us[cc];
          ya[0] = fmaf(hp[-cc], uc, ya[0]);
          ya[1] = fmaf(hprev, uc, ya[1]);
        }
      }
    }
    const float y0 = ya[0] + yb[0], y1 = ya[1] + yb[1];

    // ---- decay of the entering state, injection, carry ----
    float ys0 = 0.f, ys1 = 0.f;
    float inj[2 * kMaxS];  // real parts, then imaginary parts
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      ys0 += sr[s] * tabr[s][0] - si[s] * tabi[s][0];
      ys1 += sr[s] * tabr[s][1] - si[s] * tabi[s][1];
      inj[s] = pwr[s][0] * u0 + pwr[s][1] * u1;
      inj[kMaxS + s] = pwi[s][0] * u0 + pwi[s][1] * u1;
    }
    warp_sum16(inj, lane);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      const float nr = ar[s] * sr[s] - ai[s] * si[s] + inj[s];
      const float ni = ar[s] * si[s] + ai[s] * sr[s] + inj[kMaxS + s];
      sr[s] = nr;
      si[s] = ni;
    }

    const __nv_bfloat16 o0 = __float2bfloat16_rn(__fmul_rn(
        f[0][0], evo::to_float(__float2bfloat16_rn(y0 + ys0))));
    const __nv_bfloat16 o1 = __float2bfloat16_rn(__fmul_rn(
        f[0][1], evo::to_float(__float2bfloat16_rn(y1 + ys1))));
    __nv_bfloat16* yp = yrow + q * Ct + t0;
    if (vec) {
      if (in0) {
        __nv_bfloat162 v2;
        v2.x = o0;
        v2.y = o1;
        *reinterpret_cast<__nv_bfloat162*>(yp) = v2;
      }
    } else {
      if (in0) yp[0] = o0;
      if (in1) yp[1] = o1;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      cur[s][0] = nxt[s][0];
      cur[s][1] = nxt[s][1];
    }
    __syncwarp();
  }

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kMaxS; ++s)
      if (s < S) {
        iir[(row * S + s) * 2] = sr[s];
        iir[(row * S + s) * 2 + 1] = si[s];
      }
  }
}

template <int CT>
int launch(const void* z, const void* fir_w, const void* fir_b,
           const void* poles, const void* residues, const void* d_skip,
           const void* fir0, const void* st0, void* y, void* iir, int B,
           int C, long long L, int Ct, int S, void* stream) {
  const int64_t rows = (int64_t)B * C;
  const int vec = (L % 2 == 0) && (Ct % 2 == 0) && ((uintptr_t)z % 4 == 0) &&
                  ((uintptr_t)y % 4 == 0);
  hyena_mixer_kernel<CT><<<(unsigned)((rows + kWarps - 1) / kWarps),
                               kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)z, (const float*)fir_w, (const float*)fir_b,
      (const float*)poles, (const float*)residues, (const float*)d_skip,
      (const __nv_bfloat16*)fir0, (const float*)st0, (__nv_bfloat16*)y,
      (float*)iir, rows, C, (int64_t)L, Ct, S, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// z: (B, 3, C, L) bf16; fir_w: (3, C, 3) fp32; fir_b: (3, C) fp32 or null;
// poles, residues: (C, S, 2) fp32; d_skip: (C,) fp32; fir0: (B, 3, C, 2)
// bf16 or null; st0: (B, C, S, 2) fp32 or null; y: (B, C, L) bf16; iir:
// (B, C, S, 2) fp32; all contiguous. Ct divides L, 1 <= Ct <= 64,
// 1 <= S <= 8, KF = 3 taps; -1 for what it does not take.
extern "C" int evo_hyena_mixer_bf16(const void* z, const void* fir_w,
                                    const void* fir_b, const void* poles,
                                    const void* residues, const void* d_skip,
                                    const void* fir0, const void* st0,
                                    void* y, void* iir, int B, int C,
                                    long long L, int Ct, int S, int KF,
                                    void* stream) {
  if (Ct < 1 || Ct > kMaxChunk || L % Ct || S < 1 || S > kMaxS || KF != kTaps)
    return -1;
  return Ct == kMaxChunk
             ? launch<kMaxChunk>(z, fir_w, fir_b, poles, residues, d_skip,
                                 fir0, st0, y, iir, B, C, L, Ct, S, stream)
             : launch<0>(z, fir_w, fir_b, poles, residues, d_skip, fir0, st0,
                         y, iir, B, C, L, Ct, S, stream);
}
