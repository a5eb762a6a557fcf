// The Hyena mixer between its two projections, in one pass over the
// in-projection's output:
//
//   z  = zl + b_in                                   (bf16, one rounding)
//   z' = depthwise causal FIR(z) + bias, each stream rounded to bf16
//   x2, x1, v = z';  u = x1 * v                      (bf16)
//   y  = chunked long conv(u) + d_skip * u           (float32, see below)
//   out = x2 * bf16(y)                               (bf16)
//
// and the modal state after the last position. The long conv has the
// modal filter h[t] = Re(sum_s R_s p_s^t). Per chunk of Ct positions, with
// P_s[t] = p_s^t:
//   y_local = T u      T the lower-triangular Toeplitz of h[0..Ct), with
//                      d_skip on its diagonal
//   y_state[t] = Re(sum_s E_s P_s[t])      E_s = R_s p_s ent_s, ent the
//                                          state entering the chunk
//   inj_s   = sum_c P_s[Ct-1-c] u[c]
//   state entering the next chunk = p_s^Ct ent_s + inj_s
//
// Replaces: evo_tpu/ops/pallas_hyena.py `_mixer_kernel` (called through
// `hyena_mixer_pallas`): one launch per Hyena layer of a forward or a
// resumed segment under `hyena_fused_mixer`, 29 per forward of evo-1.
//
// Layouts: z is the in-projection's output zl (B, L, 3, C) where the
// product left it (channel stride 1, stream stride C, position stride 3C),
// so the layer makes no (B, 3, C, L) copy and no bias pass; y is written
// as (B, L, C), the layout the out-projection reads.
//
// Bound on the card: bytes, narrowly. At zl (1, 8192, 3, 4096) bf16 it
// reads 201 MB and writes 67 MB (0.080 ms at 3.35 TB/s). The function
// needs 5.1 GFLOP of float32 (0.076 ms at 67 TFLOP/s): per chunk of 64 the
// lower triangle of the Toeplitz product, 64 * 65, 4,096 for injection and
// decay, and ~26 a position for the bias, the FIR and the gates. The
// products have to be full float32: a single bf16 pass is 1e-3 off, TF32
// keeps 10 bits, and the tensor cores have no float32 mma, so they run as
// FFMA. In practice neither bound is reached: the loads hide behind the
// arithmetic, which is held back by shared-memory reads (the powers of the
// poles, the taps and u) and by the two barriers of every chunk (PERF.md,
// kernel 6).
//
// Design: a block owns one batch row and 16 channels (two blocks an SM,
// 256 blocks at B=1, C=4096) and walks all of L in chunks, so the carry
// from chunk to chunk is one complex multiply-add a state and the rest of
// a chunk's work is spread over the block's 256 threads. Each chunk's
// 64 x 3 x 16 bf16 tile of zl comes by 16-byte cp.async (zero-filled past
// C) into a ring of three, so two chunks are in flight while one computes.
// Sixteen threads a channel, lanes along the channels; thread g owns rows
// 4g .. 4g + 3 of every chunk:
//  - FIR: the bias add as one bf16 add, the 3 taps and the FIR bias in the
//    plain version's float32 order (a product of two bf16 values is exact
//    in float32, so a fused multiply-add rounds as product-then-add does),
//    rounded, gated; u goes to shared memory, x2 stays in registers for
//    the gate. The two inputs before a chunk come from a two-row halo the
//    previous chunk left (chunk 0: the carried tail, already biased, or
//    zeros).
//  - Toeplitz: only the triangle, 16 FMAs a step of 4 columns from one
//    16-byte load of u and one of taps, the tap window sliding in
//    registers; the loop is unrolled with a guard that is uniform across a
//    row of lanes. Taps sit behind 7 zeros, so the diagonal blocks need no
//    test.
//  - State: the powers P_s[0..64) are made once a block by binary
//    exponentiation from six squarings and kept in shared memory. Thread g
//    reads P_s[4g .. 4g + 3] of every state once a chunk and uses it
//    twice: for y_state at its rows (16 FMAs a position) and, since
//    P_s[63 - t] at the mirror rows 60 - 4g .. 63 - 4g is the same set,
//    for its share of inj_s there. A shuffle adds the two rows of a warp;
//    at the next chunk's first barrier the owner of state g (g < 8) adds
//    the eight shares, carries state = p^Ct state + inj and writes E for
//    the chunk. A chunk shorter than 64 has no mirror: its owner sums the
//    injection by Horner's rule.
//  - Output: y goes through a position-major bf16 tile and leaves as
//    16-byte channel rows of (B, L, C) after the next chunk's barrier.
// Two barriers a chunk. A chunk shorter than 64 (L < 64, or another chunk
// size) runs the same code over zero-padded u; the state is carried with
// p^Ct. No result depends on how blocks are scheduled.
//
// The taps, the FIR bias and d_skip are bf16 or float32 (a model whose
// param_dtype is float32 under bf16 activations): a template on their
// type, read as stored and upcast in registers, as the JAX kernel upcasts
// its tap and bias slabs and folds d_skip into its float32 Toeplitz. With
// float32 taps each product rounds, so the FIR runs product-then-add with
// no contraction, as the plain version; a bf16 weight compiles to the same
// code as before the template.
//
// Numerics: the bias add, the FIR and the gates are bit-equal to the plain
// version (the leading `0 +` of its FIR sum is skipped, which can only turn
// a -0 into +0). The long conv's sums run in another order than the plain
// version's einsums and its powers of the poles come from repeated
// squaring where the plain version takes a log-doubling range, so y agrees
// to float32 rounding before it is rounded to bf16 and an output may land
// one bf16 step away.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 64;
constexpr int kMaxS = 8;     // modal states a channel
constexpr int kCB = 16;      // channels a block
constexpr int kTpc = 16;     // threads a channel
constexpr int kThreads = kTpc * kCB;
constexpr int kPieces = kCB / 8;        // 16-byte pieces of a channel row
constexpr int kTaps = 3;     // FIR length: every published config's
constexpr int kHalo = kTaps - 1;
constexpr int kRun = kMaxChunk / kTpc;  // positions a thread
constexpr int kStages = 3;   // chunks in the cp.async ring
constexpr int kSquares = 7;  // p^(2^j), j < 7: exponents up to 127
constexpr int kOff = 7;      // hs[kOff + j] = h[j]; zeros at j = -7..-1, 64
constexpr int kHS = 76;      // floats a tap row; with kPS and kUS an odd
constexpr int kPS = 68;      // number of 16-byte units, so the rows of 8
constexpr int kUS = 68;      // channels fall in distinct bank groups
constexpr int kES = 2 * kMaxS + 1;  // floats an E row (odd: no conflicts)

struct Smem {
  float pr[kMaxS][kCB][kPS];           // P_s[t] = p_s^t, real and
  float pi[kMaxS][kCB][kPS];           // imaginary parts
  float hs[kCB][kHS];                  // taps, d_skip on h[0]
  float us[kCB][kUS];                  // u of the chunk, zeros past Ct
  float e[kCB][kES];                   // E entering the chunk
  float part[kTpc / 2][2 * kMaxS][kCB];  // shares of inj, two rows each
  bf16 z[kStages][kMaxChunk][3][kCB];  // the ring of zl tiles
  bf16 halo[2][kHalo][3][kCB];         // biased inputs before the chunk
  bf16 yt[kMaxChunk][kCB];             // the gated output, position-major
};

__device__ __forceinline__ float bf16_round(float x) {
  return evo::to_float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

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

// y[i] += sum_j h[t0 - cb + i - j] u[cb + j], i < 4, for one block of 4
// columns; w holds h[t0 - cb - 3 .. t0 - cb + 4]
__device__ __forceinline__ void toeplitz_step(float* y, const float* w,
                                              const float4& u4) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float uj = at(u4, j);
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = fmaf(w[i - j + 3], uj, y[i]);
  }
}

// slide the tap window 4 columns on: w = h[t0 - cb - 7 .. t0 - cb]
__device__ __forceinline__ void slide(float* w, const float* src) {
#pragma unroll
  for (int k = 0; k < 4; ++k) w[4 + k] = w[k];
  const float4 v = ld4(src);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load_window(float* w, const float* src) {
  const float4 a = ld4(src), b = ld4(src + 4);
  w[0] = a.x;
  w[1] = a.y;
  w[2] = a.z;
  w[3] = a.w;
  w[4] = b.x;
  w[5] = b.y;
  w[6] = b.z;
  w[7] = b.w;
}

// WT: the type of the taps, the FIR bias and d_skip (bf16 or float32)
template <typename WT>
__global__ void __launch_bounds__(kThreads, 2)
    hyena_mixer_kernel(const bf16* __restrict__ zl,
                       const WT* __restrict__ fir_w,
                       const WT* __restrict__ fir_b,
                       const bf16* __restrict__ b_in,
                       const float* __restrict__ poles,
                       const float* __restrict__ residues,
                       const WT* __restrict__ d_skip,
                       const bf16* __restrict__ fir0,
                       const float* __restrict__ st0, bf16* __restrict__ y,
                       float* __restrict__ iir, int C, int64_t L, int Ct,
                       int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCB;
  const int64_t b = blockIdx.y;
  const int64_t K = L / Ct;

  // lanes run along the channels, so a half-warp shares its row g:
  // positions t0 .. t0 + 3 for the FIR, the Toeplitz product, y_state and
  // the gate, and state g (g < 8) for the injection and the carry
  const int ch = tid % kCB, g = tid / kCB;
  const int c = c0 + ch;
  const bool cin = c < C;
  const int t0 = kRun * g, tm = kMaxChunk - kRun - t0;
  const int lane = tid % 32;
  const bool owner = g < kMaxS && g < S;  // of state g

  auto fetch = [&](int64_t q) {
    if (q < K) {
      const int slot = (int)(q % kStages);
      for (int i = tid; i < Ct * 3 * kPieces; i += kThreads) {
        const int j = i % kPieces, s = (i / kPieces) % 3,
                  t = i / (3 * kPieces);
        const int cc = c0 + 8 * j;
        const bool in = cc < C;
        evo::cp_async16_zfill(
            &sm.z[slot][t][s][8 * j],
            in ? zl + ((b * L + q * Ct + t) * 3 + s) * C + cc : zl,
            in ? 16 : 0);
      }
    }
    evo::cp_async_commit();
  };
  fetch(0);
  fetch(1);

  // ---- the channel's tables, once per block ----
  float pr = 0.f, pi = 0.f, rr = 0.f, ri = 0.f, sr = 0.f, si = 0.f;
  const int sp = g % kMaxS;  // the state whose powers this thread makes
  if (cin && sp < S) {
    const int64_t o = ((int64_t)c * S + sp) * 2;
    pr = poles[o];
    pi = poles[o + 1];
    rr = residues[o];
    ri = residues[o + 1];
    if (st0 != nullptr) {
      sr = st0[((b * C + c) * S + sp) * 2];
      si = st0[((b * C + c) * S + sp) * 2 + 1];
    }
  }
  float ar, ai;  // p^Ct
  {
    float qr[kSquares], qi[kSquares];
    qr[0] = pr;
    qi[0] = pi;
#pragma unroll
    for (int j = 1; j < kSquares; ++j) {
      qr[j] = qr[j - 1] * qr[j - 1] - qi[j - 1] * qi[j - 1];
      qi[j] = 2.f * qr[j - 1] * qi[j - 1];
    }
    // rows g and g + 8 make the two halves of P_sp
    const int half = kMaxChunk / 2 * (g / kMaxS);
    for (int t = half; t < half + kMaxChunk / 2; ++t)
      cpow(qr, qi, t, &sm.pr[sp][ch][t], &sm.pi[sp][ch][t]);
    cpow(qr, qi, Ct, &ar, &ai);
  }
  const float rpr = rr * pr - ri * pi, rpi = rr * pi + ri * pr;  // R p
  if (g < kMaxS) {
    sm.e[ch][g] = rpr * sr - rpi * si;
    sm.e[ch][kMaxS + g] = rpr * si + rpi * sr;
  }

  float w[3][kTaps], fbv[3];
  bf16 binv[3];
  const bool has_fb = fir_b != nullptr, has_bin = b_in != nullptr;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      w[s][j] =
          cin ? evo::to_float(fir_w[((int64_t)s * C + c) * kTaps + j]) : 0.f;
    fbv[s] = cin && has_fb ? evo::to_float(fir_b[s * C + c]) : 0.f;
    binv[s] = cin && has_bin ? b_in[s * C + c] : __float2bfloat16_rn(0.f);
    if (g == 0) {
#pragma unroll
      for (int k = 0; k < kHalo; ++k)
        sm.halo[0][k][s][ch] = cin && fir0 != nullptr
                                   ? fir0[((b * 3 + s) * C + c) * kHalo + k]
                                   : __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();  // the powers
  {
    // taps h[t0 .. t0 + 3], summed over the states
    float h[kRun] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < S && cin; ++s) {
      const float r0 = residues[((int64_t)c * S + s) * 2];
      const float r1 = residues[((int64_t)c * S + s) * 2 + 1];
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        h[k] += r0 * sm.pr[s][ch][t0 + k] - r1 * sm.pi[s][ch][t0 + k];
    }
    if (g == 0 && cin) h[0] += evo::to_float(d_skip[c]);
#pragma unroll
    for (int k = 0; k < kRun; ++k) sm.hs[ch][kOff + t0 + k] = h[k];
    if (g == 0) {
      for (int j = 0; j < kOff; ++j) sm.hs[ch][j] = 0.f;
      sm.hs[ch][kOff + kMaxChunk] = 0.f;
    }
  }

  auto store_tile = [&](int64_t q) {
    for (int i = tid; i < Ct * kPieces; i += kThreads) {
      const int t = i / kPieces, p = i % kPieces;
      const int cc = c0 + 8 * p;
      if (cc < C)
        *reinterpret_cast<uint4*>(y + (b * L + q * Ct + t) * C + cc) =
            *reinterpret_cast<const uint4*>(&sm.yt[t][8 * p]);
    }
  };

  // state g after the chunk whose shares of inj are in sm.part (or, for a
  // shorter chunk, whose whole injection is hor + i hoi)
  float hor = 0.f, hoi = 0.f;
  auto carry = [&]() {
    float jr = hor, ji = hoi;
    if (Ct == kMaxChunk) {
#pragma unroll
      for (int k = 0; k < kTpc / 2; ++k) {
        jr += sm.part[k][g][ch];
        ji += sm.part[k][kMaxS + g][ch];
      }
    }
    const float nr = ar * sr - ai * si + jr;
    const float ni = ar * si + ai * sr + ji;
    sr = nr;
    si = ni;
  };

  for (int64_t q = 0; q < K; ++q) {
    fetch(q + 2);
    evo::cp_async_wait<2>();
    __syncthreads();  // chunk q's tile; the previous chunk's y tile and
                      // shares of inj
    const int par = (int)(q & 1);
    const int slot = (int)(q % kStages);
    if (q > 0) {
      store_tile(q - 1);
      if (owner) {
        carry();
        sm.e[ch][g] = rpr * sr - rpi * si;
        sm.e[ch][kMaxS + g] = rpr * si + rpi * sr;
      }
    }

    // ---- bias, FIR, gate: x2 (kept in registers for the gate) and u at
    // t0 .. t0 + 3 ----
    float xv[kRun];
    {
      float uv[kRun];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        auto biased = [&](int t) {
          const bf16 v = sm.z[slot][t][s][ch];
          return has_bin ? __hadd(v, binv[s]) : v;
        };
        bf16 h2, h1;  // the inputs at t0 - 2, t0 - 1
        if (g == 0) {
          h2 = sm.halo[par][0][s][ch];
          h1 = sm.halo[par][1][s][ch];
        } else {
          h2 = biased(t0 - 2);
          h1 = biased(t0 - 1);
        }
        float z2 = evo::to_float(h2), z1 = evo::to_float(h1);
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const float z0 = evo::to_float(biased(t0 + k));
          float acc;
          if constexpr (std::is_same<WT, bf16>::value) {
            // taps and inputs are bf16, so each product is exact in
            // float32 and a fused multiply-add rounds as the plain
            // version's product-then-add
            acc = w[s][0] * z2;
            acc = fmaf(w[s][1], z1, acc);
            acc = fmaf(w[s][2], z0, acc);
          } else {
            // float32 taps: a product rounds, so product-then-add as the
            // plain version, with no contraction
            acc = __fmul_rn(w[s][0], z2);
            acc = __fadd_rn(acc, __fmul_rn(w[s][1], z1));
            acc = __fadd_rn(acc, __fmul_rn(w[s][2], z0));
          }
          if (has_fb) acc = __fadd_rn(acc, fbv[s]);
          const float f = bf16_round(acc);
          if (s == 0) xv[k] = f;
          else if (s == 1) uv[k] = f;
          else uv[k] = bf16_round(uv[k] * f);
          z2 = z1;
          z1 = z0;
        }
      }
      // the next chunk's halo: the biased inputs at Ct - 2, Ct - 1 (at a
      // chunk of one position, the older one is this chunk's halo)
      if (tid < kHalo * 3 * kCB) {
        const int k = tid / (3 * kCB), s = (tid / kCB) % 3;
        const int t = Ct - kHalo + k;
        bf16 v;
        if (t >= 0) {
          v = sm.z[slot][t][s][ch];
          if (has_bin)
            v = __hadd(v, s == 0 ? binv[0] : s == 1 ? binv[1] : binv[2]);
        } else {
          v = sm.halo[par][kHalo + t][s][ch];
        }
        sm.halo[par ^ 1][k][s][ch] = v;
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        if (t0 + k >= Ct) xv[k] = uv[k] = 0.f;
      *reinterpret_cast<float4*>(&sm.us[ch][t0]) =
          make_float4(uv[0], uv[1], uv[2], uv[3]);
    }
    __syncthreads();  // u, E

    // ---- the long conv at t0 .. t0 + 3; shares of the injection ----
    {
      const float* h = &sm.hs[ch][kOff];
      const float* u = sm.us[ch];
      float ya[kRun] = {0.f, 0.f, 0.f, 0.f};
      float wa[8];
      load_window(wa, h + t0 - 3);
      // unrolled, with a guard that is uniform across a warp (t0 is the
      // warp's), so the window stays in registers and no lane idles
#pragma unroll
      for (int cb = 0; cb < kMaxChunk; cb += 4) {
        if (cb > t0) break;
        toeplitz_step(ya, wa, ld4(u + cb));
        slide(wa, h + t0 - cb - 7);
      }

      // y_state = Re(sum_s E_s P_s[t])
      // y_state = Re(sum_s E_s P_s[t]) at t0 .. t0 + 3; and, from the same
      // powers, this row's share of inj_s over the mirror rows tm .. tm + 3
      // (at Ct = 64, P_s[Ct-1-t] there is P_s[t0 + 3 - i]), summed with
      // the other row of the warp and left for the owner
      const float4 um = ld4(u + tm);
      const bool shares = Ct == kMaxChunk;
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
        if (s < S) {
          const float er = sm.e[ch][s], nei = -sm.e[ch][kMaxS + s];
          const float4 pa = ld4(&sm.pr[s][ch][t0]);
          const float4 qa = ld4(&sm.pi[s][ch][t0]);
          float jr = 0.f, ji = 0.f;
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            ya[i] = fmaf(nei, at(qa, i), fmaf(er, at(pa, i), ya[i]));
            jr = fmaf(at(pa, kRun - 1 - i), at(um, i), jr);
            ji = fmaf(at(qa, kRun - 1 - i), at(um, i), ji);
          }
          if (shares) {
            jr += __shfl_xor_sync(0xffffffffu, jr, 16);
            ji += __shfl_xor_sync(0xffffffffu, ji, 16);
            if (lane < 16) {
              sm.part[g / 2][s][ch] = jr;
              sm.part[g / 2][kMaxS + s][ch] = ji;
            }
          }
        }
      }
      if (!shares && owner) {
        // a shorter chunk: state g's whole injection by Horner's rule
        const float pr = sm.pr[g][ch][1], pi = sm.pi[g][ch][1];
        float jr = 0.f, ji = 0.f;
        for (int t = 0; t < Ct; ++t) {
          const float nr = jr * pr - ji * pi + u[t];
          ji = jr * pi + ji * pr;
          jr = nr;
        }
        hor = jr;
        hoi = ji;
      }

      // gate: out = x2 * bf16(y_local + y_state)
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if (t0 + i < Ct)
          sm.yt[t0 + i][ch] = __float2bfloat16_rn(xv[i] * bf16_round(ya[i]));
    }
  }
  __syncthreads();
  store_tile(K - 1);
  if (cin && owner) {
    carry();
    iir[((b * C + c) * S + g) * 2] = sr;
    iir[((b * C + c) * S + g) * 2 + 1] = si;
  }
}

template <typename WT>
int launch(const void* zl, const void* fir_w, const void* fir_b,
           const void* b_in, const void* poles, const void* residues,
           const void* d_skip, const void* fir0, const void* st0, void* y,
           void* iir, int B, int C, long long L, int Ct, int S, int KF,
           void* stream) {
  if (Ct < 1 || Ct > kMaxChunk || L % Ct || S < 1 || S > kMaxS ||
      KF != kTaps || C % 8)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      hyena_mixer_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kCB - 1) / kCB, B);
  hyena_mixer_kernel<WT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zl, (const WT*)fir_w, (const WT*)fir_b,
      (const bf16*)b_in, (const float*)poles, (const float*)residues,
      (const WT*)d_skip, (const bf16*)fir0, (const float*)st0, (bf16*)y,
      (float*)iir, C, (int64_t)L, Ct, S);
  return (int)cudaGetLastError();
}

}  // namespace

// zl: the in-projection's output (B, L, 3, C), contiguous, 16-byte aligned;
// fir_w: (3, C, 3); fir_b, b_in: (3, C) or null; d_skip: (C,); fir0:
// (B, 3, C, 2) or null; all bf16. poles, residues: (C, S, 2) fp32; st0:
// (B, C, S, 2) fp32 or null; y: (B, L, C) bf16; iir: (B, C, S, 2) fp32; all
// contiguous. Ct divides L, 1 <= Ct <= 64, 1 <= S <= 8, KF = 3 taps,
// C % 8 == 0.
extern "C" int evo_hyena_mixer_bf16(const void* zl, const void* fir_w,
                                    const void* fir_b, const void* b_in,
                                    const void* poles, const void* residues,
                                    const void* d_skip, const void* fir0,
                                    const void* st0, void* y, void* iir,
                                    int B, int C, long long L, int Ct, int S,
                                    int KF, void* stream) {
  return launch<bf16>(zl, fir_w, fir_b, b_in, poles, residues, d_skip, fir0,
                      st0, y, iir, B, C, L, Ct, S, KF, stream);
}

// the same with fir_w, fir_b and d_skip in float32 (param_dtype float32
// under bf16 activations), read as stored; b_in and fir0 stay bf16
extern "C" int evo_hyena_mixer_bf16_wf32(
    const void* zl, const void* fir_w, const void* fir_b, const void* b_in,
    const void* poles, const void* residues, const void* d_skip,
    const void* fir0, const void* st0, void* y, void* iir, int B, int C,
    long long L, int Ct, int S, int KF, void* stream) {
  return launch<float>(zl, fir_w, fir_b, b_in, poles, residues, d_skip, fir0,
                       st0, y, iir, B, C, L, Ct, S, KF, stream);
}
