// Flash attention of a query segment at an offset over a KV buffer: bf16
// buffers (kernel 4), or int8 buffers with one fp32 scale per (position,
// head) (kernel 5), and the combine kernel of kernel 5's split key range.
//
// Replaces: evo_tpu/ops/pallas_attention.py `_flash_buffer_kernel` and
// `_flash_buffer_kernel_q8` (both called through `flash_attention_buffer`).
// Query row r of batch row b sits at absolute position offset[b] + r and
// attends the keys col <= offset[b] + r of a buffer of T positions. One
// launch per attention layer for every resumed prefill segment (3 per
// segment of evo-1) and for every decode step (Lq = 1; bf16 and int8).
//
// Bound on the card: operations for a prefill segment, bytes for decode.
// At B=1, Lq=8192, offset=122,880, H=32, Dh=128 the two products are
// ~1.7e13 operations, ~17 ms at 989 TFLOP/s dense bf16, while the live 2.1
// GB of bf16 K and V take 0.64 ms at 3.35 TB/s. At Lq=1 over 122,880 int8
// positions the kernel reads ~1.04 GB, 0.31 ms, and computes next to
// nothing.
//
// Kernels 4 and 5 at many query rows are the Hopper mainloop of
// `flash_sm90.cuh` with the (B,) device offsets: TMA loads of the cache
// through its strides, wgmma products, key tiles only up to offset[b] +
// the tile's last row (capped at T), and only the tiles that cross a
// row's limit or T masked. Kernel 5 stages the int8 codes by TMA and its
// two producer warpgroups dequantise them into the bf16 tiles the
// products read (see the header).
//
// Kernel 5 at few query rows (Lq <= 4: decode, and the short tail of a
// resumed prompt) splits the key range instead, since one 128-row tile a
// (batch, head) would give 32 blocks at B=1 to 132 SMs, each walking the
// whole live prefix alone. The grid is (B*H, S): block (bh, s) takes keys
// [s * chunk, (s + 1) * chunk) up to the live prefix, S chosen by the
// wrapper to put about four blocks on every SM. A warp takes 16 keys a
// step, 8 threads a key, each 16 codes (16-byte loads: 8 in flight a
// thread, K and V of 4 keys), dequantised in registers as
// bf16(float(code) * scale); the dot products are 8-lane shuffle sums, no
// tensor cores (one query row is ~2 GFLOP a decode step over the three
// layers). Each warp keeps its own online-softmax state (log2 units, the
// `finite` guard, P rounded to bf16 before P V); the block merges its four
// warps in a fixed order and writes one partial (m in natural-log units,
// l, acc[128]) in fp32 to scratch that the wrapper allocates. A block
// whose keys lie wholly past a row's live prefix writes m = -inf, l = 0.
// The combine kernel merges the S partials of a row in order, with no
// atomics: the same input gives the same bits.
//
// A masked key still enters P V with p = 0, and 0 * NaN is NaN: buffers
// must hold finite values everywhere (the cache is made of zeros).

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitMaxRows = 4;    // the wrapper's regime threshold

// 16 int8 codes times `s`, rounded to bf16, as 16 floats
__device__ __forceinline__ void dequant16(const uint4 w, float s,
                                          float (&f)[16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint2 p = evo_sm90::dequant4(words[i], s);
    f[4 * i] = __uint_as_float(p.x << 16);
    f[4 * i + 1] = __uint_as_float(p.x & 0xffff0000u);
    f[4 * i + 2] = __uint_as_float(p.y << 16);
    f[4 * i + 3] = __uint_as_float(p.y & 0xffff0000u);
  }
}

// Partial attention of R query rows (rows past Lq repeat row Lq - 1 and
// are never written) over one split of the key range. pm, pl: (B, H, Lq,
// S); pacc: (B, H, Lq, S, 128).
template <int R>
__global__ void __launch_bounds__(kSplitThreads)
    flash_buffer_q8_split_kernel(
        const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kbuf,
        const int8_t* __restrict__ vbuf, const float* __restrict__ kscale,
        const float* __restrict__ vscale, const int* __restrict__ offsets,
        float* __restrict__ pm, float* __restrict__ pl,
        float* __restrict__ pacc, int Lq, int T, int H, int64_t qsb,
        int64_t qsl, int64_t qsh, int64_t ksb, int64_t ksl, int64_t ksh,
        int64_t vsb, int64_t vsl, int64_t vsh, int chunk,
        float scale_log2) {
  __shared__ float wm[4][R], wl[4][R];
  __shared__ float wacc[4][R][kHeadDim];

  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int bb = bh / H, hh = bh % H;
  const int off = offsets[bb];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, sub = lane & 7;  // key of a pass; 16 columns
  const int k_lo = split * chunk;
  const int k_hi = min(min(k_lo + chunk, T), off + Lq);  // exclusive

  float qf[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const __nv_bfloat16* qp =
        q + bb * qsb + min(r, Lq - 1) * qsl + hh * qsh + 16 * sub;
    const uint4 a = *reinterpret_cast<const uint4*>(qp);
    const uint4 b = *reinterpret_cast<const uint4*>(qp + 8);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qf[r][2 * i] = __uint_as_float(w[i] << 16);
      qf[r][2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  float m[R], l[R], acc[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.f;
  }
  const int8_t* const kp = kbuf + bb * ksb + hh * ksh + 16 * sub;
  const int8_t* const vp = vbuf + bb * vsb + hh * vsh + 16 * sub;
  const float* const ksc = kscale + ((int64_t)bb * H + hh) * T;
  const float* const vsc = vscale + ((int64_t)bb * H + hh) * T;

  // a warp's 16 keys a step: 4 passes of 4 keys, one a group of 8 lanes
  for (int k0 = k_lo + 16 * warp; k0 < k_hi; k0 += 64) {
    uint4 kw[4], vw[4];
    float sk[4], sv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int key = k0 + 4 * p + grp;
      const bool valid = key < k_hi;
      kw[p] = valid ? __ldcs(reinterpret_cast<const uint4*>(kp + key * ksl))
                    : make_uint4(0u, 0u, 0u, 0u);
      vw[p] = valid ? __ldcs(reinterpret_cast<const uint4*>(vp + key * vsl))
                    : make_uint4(0u, 0u, 0u, 0u);
      sk[p] = valid ? ksc[key] : 0.f;
      sv[p] = valid ? vsc[key] : 0.f;
    }
    float s[4][R];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float kf[16];
      dequant16(kw[p], sk[p], kf);
      const int key = k0 + 4 * p + grp;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) d = fmaf(qf[r][e], kf[e], d);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        s[p][r] = (key < k_hi && key <= off + r) ? d * scale_log2 : -INFINITY;
      }
    }
    float pb[4][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = fmaxf(fmaxf(s[0][r], s[1][r]), fmaxf(s[2][r], s[3][r]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[r], mx);
      const bool finite = m_new != -INFINITY;
      const float m_safe = finite ? m_new : 0.f;
      const float alpha = finite ? evo_sm90::ex2(m[r] - m_safe) : 1.f;
      float rs = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float x = evo_sm90::ex2(s[p][r] - m_safe);
        rs += x;
        pb[p][r] = __bfloat162float(__float2bfloat16_rn(x));
      }
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float vf[16];
      dequant16(vw[p], sv[p], vf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[r][e] = fmaf(pb[p][r], vf[e], acc[r][e]);
    }
  }

  // the warp's sums over its four key groups, then the block's four warps
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 8);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 8);
      acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) wacc[warp][r][16 * sub + e] = acc[r][e];
    }
  }
  __syncthreads();
  const int d = threadIdx.x;  // one column of the head a thread
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= Lq) break;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wm[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wgt =
          wm[w][r] == -INFINITY ? 0.f : evo_sm90::ex2(wm[w][r] - M);
      L = fmaf(wgt, wl[w][r], L);
      A = fmaf(wgt, wacc[w][r][d], A);
    }
    const int64_t row = ((int64_t)bh * Lq + r) * S + split;
    pacc[row * kHeadDim + d] = A;
    if (d == 0) {
      pm[row] = M * 0.6931471805599453f;  // log2 units to natural
      pl[row] = L;
    }
  }
}

// o (B, Lq, H, 128) bf16 from the S partials of each row, merged in order
__global__ void __launch_bounds__(kHeadDim)
    combine_partials_kernel(const float* __restrict__ pm,
                            const float* __restrict__ pl,
                            const float* __restrict__ pacc,
                            __nv_bfloat16* __restrict__ o, int H, int Lq,
                            int S) {
  const int64_t row = blockIdx.x;  // (b H + h) Lq + r
  const int d = threadIdx.x;
  const float* const m = pm + row * S;
  const float* const l = pl + row * S;
  const float* const acc = pacc + row * S * kHeadDim + d;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m[s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = m[s] == -INFINITY ? 0.f : expf(m[s] - M);
    L = fmaf(w, l[s], L);
    A = fmaf(w, acc[(int64_t)s * kHeadDim], A);
  }
  const int64_t bh = row / Lq, r = row % Lq;
  const int64_t b = bh / H, h = bh % H;
  o[((b * Lq + r) * H + h) * kHeadDim + d] =
      __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
}

template <int R>
int launch_split(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* offsets, void* m, void* l,
                 void* acc, int B, int Lq, int T, int H, long long qsb,
                 long long qsl, long long qsh, long long ksb, long long ksl,
                 long long ksh, long long vsb, long long vsl, long long vsh,
                 int chunk, int S, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, S);
  flash_buffer_q8_split_kernel<R><<<grid, kSplitThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v,
      (const float*)ks, (const float*)vs, (const int*)offsets, (float*)m,
      (float*)l, (float*)acc, Lq, T, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb,
      vsl, vsh, chunk, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Lq, H, 128) bf16; k, v: buffers of T positions, bf16; offsets:
// (B,) int32; o: (B, Lq, H, 128) bf16, contiguous. q, k and v are read
// by TMA through element strides (batch, position, head; the last axis
// contiguous; strides multiples of 8 and pointers 16-byte aligned).
extern "C" int evo_flash_attention_buffer_bf16(
    const void* q, const void* k, const void* v, const void* offsets,
    void* o, int B, int Lq, int T, int H, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, float scale, void* stream) {
  return evo_sm90::launch<false>(
      q, k, v, nullptr, nullptr, (const int*)offsets, o, B, Lq, T, H, qsb,
      qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale, (cudaStream_t)stream);
}

// As above with int8 k, v (strides multiples of 16) and contiguous fp32
// scales ks, vs of shape (B, H, T): the TMA + wgmma mainloop, the codes
// dequantised by the two producer warpgroups.
extern "C" int evo_flash_attention_buffer_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* offsets, void* o, int B, int Lq, int T,
    int H, long long qsb, long long qsl, long long qsh, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl,
    long long vsh, float scale, void* stream) {
  return evo_sm90::launch<true>(q, k, v, (const float*)ks, (const float*)vs,
                                (const int*)offsets, o, B, Lq, T, H, qsb,
                                qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh,
                                scale, (cudaStream_t)stream);
}

// The same operands for Lq <= 4, split into S ranges of `chunk` keys:
// writes the partials m, l (B, H, Lq, S) and acc (B, H, Lq, S, 128), fp32
// contiguous, for evo_combine_partials.
extern "C" int evo_flash_attention_buffer_q8_split(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* offsets, void* m, void* l, void* acc, int B,
    int Lq, int T, int H, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, int chunk, int S, float scale,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (Lq < 1 || Lq > kSplitMaxRows) return (int)cudaErrorInvalidValue;
  if (Lq == 1)
    return launch_split<1>(q, k, v, ks, vs, offsets, m, l, acc, B, Lq, T, H,
                           qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, chunk,
                           S, scale, st);
  if (Lq == 2)
    return launch_split<2>(q, k, v, ks, vs, offsets, m, l, acc, B, Lq, T, H,
                           qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, chunk,
                           S, scale, st);
  return launch_split<kSplitMaxRows>(q, k, v, ks, vs, offsets, m, l, acc, B,
                                     Lq, T, H, qsb, qsl, qsh, ksb, ksl, ksh,
                                     vsb, vsl, vsh, chunk, S, scale, st);
}

// m, l: (B, H, Lq, S), acc: (B, H, Lq, S, 128) fp32 contiguous; o: (B, Lq,
// H, 128) bf16 contiguous.
extern "C" int evo_combine_partials(const void* m, const void* l,
                                    const void* acc, void* o, int B, int H,
                                    int Lq, int S, void* stream) {
  combine_partials_kernel<<<B * H * Lq, kHeadDim, 0, (cudaStream_t)stream>>>(
      (const float*)m, (const float*)l, (const float*)acc,
      (__nv_bfloat16*)o, H, Lq, S);
  return (int)cudaGetLastError();
}
