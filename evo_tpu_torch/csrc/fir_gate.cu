// Hyena FIR + gate: the in-projection bias, the depthwise causal short FIR
// (3 taps) plus its bias over the three projected bf16 streams, each stream
// rounded to bf16, then x2 = stream 0 and u = stream 1 * stream 2, written
// as (B, C, L) rows for the long conv. The K-1 inputs before t = 0 are
// zeros for a fresh sequence, or the carried tail (B, 3, C, K-1) of the
// previous segment for a resumed one (already biased).
//
// Replaces: evo_tpu/ops/pallas_fir.py `_fir_gate_kernel` (called through
// `fir_gate_pallas`): one launch per Hyena layer at prefill and in scoring,
// 29 per forward pass or resumed segment of evo-1. (The JAX package leaves
// its kernel for `fir_causal_conv` when a tail is carried; here resumed
// segments stay on the kernel.)
//
// Input layout: the in-projection's output zl (B, L, 3, C) where the
// product left it (channel stride 1, stream stride C, position stride 3C),
// so the layer makes no (B, 3, C, L) copy and no separate bias pass; the
// kernel reads 128-byte channel rows and writes 128-byte position rows,
// a transpose through shared memory.
//
// Bound on the card: bytes. It reads 3 values and writes 2 per (b, c, t)
// and does ~25 operations on them. At B=1, C=4096, L=8192 bf16 it moves
// 335 MB: ~100 us at 3.35 TB/s.
//
// Design: a block owns 64 positions x 64 channels x 3 streams of one batch
// row plus the 2 positions before them (25 KB), loaded with 16-byte
// cp.async (zero-filled past the ends), and the taps and biases of its 64
// channels (as float, once per block). Four blocks an SM keep ~2 tiles in
// flight while the others compute. A thread then owns a channel pair and
// 8 positions: it reads 4-byte (pair) words down its column, adds the
// in-projection bias to both channels in one bf16x2 add, slides the
// 3-tap window along t in registers, and writes 16-byte rows of 8
// positions for each of its two channels; the two half-warps take
// neighbouring 8-position runs, so a warp's stores fill whole 32-byte
// sectors. Rows 8-15 mod 16 of the tile swap the halves of their 128
// bytes, so the two half-warps, 8 rows apart, read disjoint banks.
//
// Numerics match the plain version bit for bit: `zl + b_in` is one bf16x2
// add (single rounding of the exact sum, which equals torch's float32 sum
// rounded to bf16, since float32 carries more than twice bf16's
// precision); taps and bias are summed in float32 in the plain version's
// order with __fmul_rn/__fadd_rn (no FMA contraction); each stream is
// rounded to bf16 before the gate, and the gate is one bf16x2 product (the
// float32 product of two bf16 values is exact, so one rounding either way).
// A missing bias is a zero one, which changes no output bit: the float32
// sum starts at +0 and so is never -0, and a zero input's sign never
// reaches it.
//
// The taps and the FIR bias are bf16 or float32 (a model whose
// param_dtype is float32 under bf16 activations): a template on their
// type, read as stored and upcast once a block, as the JAX kernel upcasts
// `w_ref` and `b_ref`; the sums above are product-then-add in float32
// either way, so the float32 taps meet the plain version's order too. A
// bf16 weight compiles to the same code as before the template.

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTaps = 3;  // short_filter_length of every evo config
constexpr int kHalo = kTaps - 1;
constexpr int kTileT = 64;                    // positions a block
constexpr int kTileC = 64;                    // channels a block
constexpr int kRows = kTileT + kHalo;         // tile rows, halo first
constexpr int kChunks = kTileC * 2 / 16;      // 16-byte chunks a row
constexpr int kLoads = kRows * 3 * kChunks;   // chunks a tile
constexpr int kThreads = 256;
constexpr int kRun = 8;                       // positions a thread

struct Smem {
  uint4 z[3][kRows][kChunks];                 // 25,344 bytes
  float w[3][kTaps][kTileC];                  // taps as float
  float fb[3][kTileC];                        // FIR bias as float
  uint32_t bin[3][kTileC / 2];                // in-projection bias, bf16x2
};

// where chunk j of tile row r lies: rows 8-15 mod 16 swap the two halves
__device__ __forceinline__ int swizzle(int r, int j) {
  return j ^ (((r >> 3) & 1) << 2);
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float lo_float(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_float(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 8 positions of one channel: one 16-byte store where the row allows it
__device__ __forceinline__ void store_run(bf16* dst, const uint32_t* v,
                                          int n, bool vec) {
  if (vec && n == kRun) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
  uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
  for (int k = 0; k < kRun; ++k)
    if (k < n) d[k] = (uint16_t)(v[k / 2] >> (16 * (k & 1)));
}

// one tile: positions t0 .. t0+63, channels c0 .. c0+63 of batch row b;
// WT the type of the taps and the FIR bias (bf16 or float32)
template <typename WT>
__device__ __forceinline__ void fir_gate_tile(
    Smem& sm, const bf16* __restrict__ zl, const WT* __restrict__ w,
    const WT* __restrict__ fb, const bf16* __restrict__ bin,
    const bf16* __restrict__ tail, bf16* __restrict__ x2,
    bf16* __restrict__ u, int C, int L, int t0, int c0, int64_t b) {
  const int tid = threadIdx.x;

  // -- the tile: rows r = 0 .. kRows-1 hold positions t0 - kHalo + r
  const bf16* zb = zl + b * L * 3 * C;
  for (int i = tid; i < kLoads; i += kThreads) {
    const int j = i % kChunks;
    const int s = (i / kChunks) % 3;
    const int r = i / (3 * kChunks);
    const int t = t0 + r - kHalo;
    const int c = c0 + 8 * j;
    if (t < 0) continue;  // before the sequence: filled below
    const bool in = t < L && c < C;
    evo::cp_async16_zfill(&sm.z[s][r][swizzle(r, j)],
                          in ? zb + ((int64_t)t * 3 + s) * C + c : zl,
                          in ? 16 : 0);
  }
  evo::cp_async_commit();
  for (int i = tid; i < 3 * kTileC; i += kThreads) {
    const int s = i / kTileC, cc = i % kTileC, c = c0 + cc;
    const bool in = c < C;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      sm.w[s][j][cc] =
          in ? evo::to_float(w[((int64_t)s * C + c) * kTaps + j]) : 0.f;
    sm.fb[s][cc] = in && fb != nullptr ? evo::to_float(fb[s * C + c]) : 0.f;
    reinterpret_cast<bf16*>(sm.bin[s])[cc] =
        in && bin != nullptr ? bin[s * C + c] : __float2bfloat16_rn(0.f);
    if (t0 == 0) {
      // the inputs before t = 0 (tile rows 0, 1, which are not swizzled):
      // the carried tail, or zeros
      bf16 v0 = __float2bfloat16_rn(0.f), v1 = v0;
      if (tail != nullptr && in) {
        const bf16* tr = tail + ((b * 3 + s) * C + c) * kHalo;
        v0 = tr[0];
        v1 = tr[1];
      }
      reinterpret_cast<bf16*>(sm.z[s][0])[cc] = v0;
      reinterpret_cast<bf16*>(sm.z[s][1])[cc] = v1;
    }
  }
  evo::cp_async_wait<0>();
  __syncthreads();

  // -- a channel pair and a run of 8 positions per thread
  const int warp = tid >> 5, lane = tid & 31;
  const int cp = 16 * (warp & 1) + (lane & 15);      // pair in the tile
  const int p0 = 16 * (warp >> 1) + kRun * (lane >> 4);
  const int c = c0 + 2 * cp;
  const int t = t0 + p0;
  if (c >= C || t >= L) return;
  const int n = min(kRun, L - t);
  const bool vec = (L % kRun) == 0;
  // at t == 0 the two rows before the run come from the tail or zeros,
  // which carry no in-projection bias
  const bool bias_halo = t > 0;
  const int64_t out0 = (b * C + c) * L + t;

  uint32_t r1[2][kRun / 2];  // stream 1, rounded: channel c, channel c + 1
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float wa[kTaps], wb[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const float2 wj = *reinterpret_cast<const float2*>(&sm.w[s][j][2 * cp]);
      wa[j] = wj.x;
      wb[j] = wj.y;
    }
    const float2 fbs = *reinterpret_cast<const float2*>(&sm.fb[s][2 * cp]);
    const uint32_t bs = sm.bin[s][cp];
    // word `cp` of tile row p0 + k: channels c, c + 1 at position t - 2 + k
    auto row = [&](int k) -> uint32_t {
      const int r = p0 + k;
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(sm.z[s][r]);
      uint32_t v = rw[4 * swizzle(r, cp >> 2) + (cp & 3)];
      if (k >= kHalo || bias_halo) v = add_bf16x2(v, bs);
      return v;
    };
    float win_a[kTaps], win_b[kTaps];
#pragma unroll
    for (int k = 0; k < kHalo; ++k) {
      const uint32_t v = row(k);
      win_a[k + 1] = lo_float(v);
      win_b[k + 1] = hi_float(v);
    }
    uint32_t ra[kRun / 2], rb[kRun / 2];
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
#pragma unroll
      for (int j = 0; j + 1 < kTaps; ++j) {
        win_a[j] = win_a[j + 1];
        win_b[j] = win_b[j + 1];
      }
      const uint32_t v = row(q + kHalo);
      win_a[kTaps - 1] = lo_float(v);
      win_b[kTaps - 1] = hi_float(v);
      // the plain version's order: 0 + w0 z(t-2) + w1 z(t-1) + w2 z(t) + b
      float aa = 0.f, ab = 0.f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        aa = __fadd_rn(aa, __fmul_rn(wa[j], win_a[j]));
        ab = __fadd_rn(ab, __fmul_rn(wb[j], win_b[j]));
      }
      aa = __fadd_rn(aa, fbs.x);
      ab = __fadd_rn(ab, fbs.y);
      if (q & 1) {
        ra[q / 2] = evo::pack_bf16(pa, aa);
        rb[q / 2] = evo::pack_bf16(pb, ab);
      } else {
        pa = aa;
        pb = ab;
      }
    }
    if (s == 0) {
      store_run(x2 + out0, ra, n, vec);
      store_run(x2 + out0 + L, rb, n, vec);
    } else if (s == 1) {
#pragma unroll
      for (int k = 0; k < kRun / 2; ++k) {
        r1[0][k] = ra[k];
        r1[1][k] = rb[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRun / 2; ++k) {
        ra[k] = mul_bf16x2(r1[0][k], ra[k]);
        rb[k] = mul_bf16x2(r1[1][k], rb[k]);
      }
      store_run(u + out0, ra, n, vec);
      store_run(u + out0 + L, rb, n, vec);
    }
  }
}

// blocks along the sequence first: a tile's two halo rows were loaded by
// the block before it, so they come from L2
template <typename WT>
__global__ void __launch_bounds__(kThreads, 4)
    fir_gate_kernel(const bf16* __restrict__ zl, const WT* __restrict__ w,
                    const WT* __restrict__ fb, const bf16* __restrict__ bin,
                    const bf16* __restrict__ tail, bf16* __restrict__ x2,
                    bf16* __restrict__ u, int C, int L) {
  __shared__ Smem sm;
  fir_gate_tile<WT>(sm, zl, w, fb, bin, tail, x2, u, C, L,
                    blockIdx.x * kTileT, blockIdx.y * kTileC, blockIdx.z);
}

template <typename WT>
int launch(const void* zl, const void* w, const void* fir_b,
           const void* b_in, const void* tail, void* x2, void* u, int B,
           int C, int L, int K, void* stream) {
  if (K != kTaps || C % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kTileT - 1) / kTileT, (C + kTileC - 1) / kTileC, B);
  fir_gate_kernel<WT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)zl, (const WT*)w, (const WT*)fir_b, (const bf16*)b_in,
      (const bf16*)tail, (bf16*)x2, (bf16*)u, C, L);
  return (int)cudaGetLastError();
}

}  // namespace

// zl: the in-projection's output (B, L, 3, C), contiguous, 16-byte aligned;
// w: (3, C, 3); fir_b, b_in: (3, C) or null; tail: (B, 3, C, 2) or null;
// x2/u: (B, C, L); all bf16 and contiguous. C % 8 == 0; K must be 3.
extern "C" int evo_fir_gate_bf16(const void* zl, const void* w,
                                 const void* fir_b, const void* b_in,
                                 const void* tail, void* x2, void* u, int B,
                                 int C, int L, int K, void* stream) {
  return launch<bf16>(zl, w, fir_b, b_in, tail, x2, u, B, C, L, K, stream);
}

// the same with the taps w and the FIR bias fir_b in float32 (param_dtype
// float32 under bf16 activations), read as stored; b_in stays bf16, as
// the layer rounds it to the activation type before the FIR
extern "C" int evo_fir_gate_bf16_wf32(const void* zl, const void* w,
                                      const void* fir_b, const void* b_in,
                                      const void* tail, void* x2, void* u,
                                      int B, int C, int L, int K,
                                      void* stream) {
  return launch<float>(zl, w, fir_b, b_in, tail, x2, u, B, C, L, K, stream);
}
