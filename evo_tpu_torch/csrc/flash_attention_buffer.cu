// Flash attention of a query segment at an offset over a KV buffer: bf16
// buffers (kernel 4), or int8 buffers with one fp32 scale per (position,
// head) (kernel 5), the split key range both take at few query rows, and
// the combine kernel of that split.
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
// GB of bf16 K and V take 0.64 ms at 3.35 TB/s. At Lq=1 over 122,880
// positions the kernel reads ~2.0 GB of bf16 (0.60 ms) or ~1.04 GB of int8
// (0.31 ms), and computes next to nothing.
//
// Kernels 4 and 5 at many query rows are the Hopper mainloop of
// `flash_sm90.cuh` with the (B,) device offsets: TMA loads of the cache
// through its strides, wgmma products, key tiles only up to offset[b] +
// the tile's last row (capped at T), and only the tiles that cross a
// row's limit or T masked. Kernel 5 stages the int8 codes by TMA and its
// two producer warpgroups dequantise them into the bf16 tiles the
// products read (see the header).
//
// At few query rows (decode, a verify pass, the short tail of a resumed
// prompt) both split the key range instead, since one 128-row tile a
// (batch, head) would give 32 blocks at B=1 to 132 SMs, each walking the
// whole live prefix alone. The grid is (B*H, S), S fixed by the wrapper
// from the buffer (or the live prefix of an int offset), B*H and the SM
// count, so it stays the same from step to step under a CUDA graph. Block
// (bh, s) sizes its own range from offset[b] in device memory: with n =
// min(offset[b] + Lq, T) live keys, chunk = ceil(n / S) rounded up to 64
// keys, it takes [s * chunk, min((s + 1) * chunk, n)). So the work follows
// each row's live prefix and nothing is read back to the host; a block
// whose range is empty writes m = -inf, l = 0, acc = 0.
//
// Kernel 5's split (Lq <= 4): a warp takes 16 keys a step, 8 threads a
// key, each 16 codes (16-byte loads: 8 in flight a thread, K and V of 4
// keys), dequantised in registers as bf16(float(code) * scale); the dot
// products are 8-lane shuffle sums, no tensor cores (one query row is ~2
// GFLOP a decode step over the three layers).
//
// Kernel 4's split (Lq <= 16): the block stages tiles of 64 keys of K and
// V (256-byte rows of one head at the cache's token stride) into shared
// memory through a ring of three stages by 16-byte cp.async copies (64 KB
// in flight a block, two blocks an SM), under an XOR swizzle of the
// 16-byte chunks by the row that keeps ldmatrix free of bank conflicts.
// Each of the four warps takes 16 keys of a tile: S = Q K^T by
// mma.sync.m16n8k16 (bf16 -> fp32) with the query rows, zero-padded to 16,
// in registers as the A operand and K by ldmatrix; P rounded to bf16 is
// the A operand of P V with V by ldmatrix.trans. One query row pads the
// products 16-fold, ~32 GFLOP a layer at offset 122,879, still a tenth of
// the time the bytes take.
//
// Both keep one online-softmax state a warp (log2 units, the `finite`
// guard, P rounded to bf16 before P V); the block merges its four warps
// in a fixed order and writes one partial (m in natural-log units, l,
// acc[128]) in fp32 to scratch that the wrapper allocates. The combine
// kernel merges the S partials of a row in order, with no atomics: the
// same input gives the same bits.
//
// A masked key still enters P V with p = 0, and 0 * NaN is NaN: buffers
// must hold finite values everywhere (the cache is made of zeros). Keys
// past a block's range are not read: their stage rows are zero-filled.

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitMaxRows = 4;    // the wrapper's regime threshold
constexpr int kSplitStep = 64;      // a range is a multiple of this

// kernel 4's split: query rows (the m16 tile), warps (16 keys of a tile
// each), keys a stage, stages, blocks resident on an SM (the wrapper's
// SPLIT_BLOCKS_PER_SM_BF16)
constexpr int kBf16Rows = 16;
constexpr int kBf16Warps = 4;
constexpr int kBf16Threads = 32 * kBf16Warps;
constexpr int kBf16Tile = 16 * kBf16Warps;
constexpr int kBf16Stages = 3;
constexpr int kBf16BlocksPerSm = 2;
constexpr int kBf16SmemBytes = kBf16Stages * 2 * kBf16Tile * kHeadDim * 2;
static_assert(kBf16Warps * kBf16Rows * (kHeadDim + 2) * 4 <= kBf16SmemBytes,
              "the warps' partials reuse the stages");
static_assert(kBf16Threads % kHeadDim == 0, "a thread a column");

// The keys [lo, hi) of split s of S over a batch row whose live prefix
// is min(off + Lq, T) keys: ceil(n / S) rounded up to kSplitStep a split.
__device__ __forceinline__ void split_range(int off, int Lq, int T, int s,
                                            int S, int& lo, int& hi) {
  const int n = max(0, min(off + Lq, T));
  const int chunk =
      ((n + S - 1) / S + kSplitStep - 1) / kSplitStep * kSplitStep;
  lo = s * chunk;
  hi = min(lo + chunk, n);
}

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
        int offset0, float* __restrict__ pm, float* __restrict__ pl,
        float* __restrict__ pacc, int Lq, int T, int H, int64_t qsb,
        int64_t qsl, int64_t qsh, int64_t ksb, int64_t ksl, int64_t ksh,
        int64_t vsb, int64_t vsl, int64_t vsh, float scale_log2) {
  __shared__ float wm[4][R], wl[4][R];
  __shared__ float wacc[4][R][kHeadDim];

  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int bb = bh / H, hh = bh % H;
  const int off = offsets != nullptr ? offsets[bb] : offset0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, sub = lane & 7;  // key of a pass; 16 columns
  int k_lo, k_hi;
  split_range(off, Lq, T, split, S, k_lo, k_hi);

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Partial attention of Lq <= 16 query rows over one split of a bf16 key
// range (see the top of the file). pm, pl: (B, H, Lq, S); pacc: (B, H, Lq,
// S, 128). In a warp, lane = 4 g + t holds rows g and g + 8 of the mma
// fragments: scores of keys 2t, 2t + 1 (+ 8) of the warp's 16, and output
// columns 8 n + 2t, + 1 for n < 16.
__global__ void __launch_bounds__(kBf16Threads, kBf16BlocksPerSm)
    flash_buffer_bf16_split_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ kbuf,
        const __nv_bfloat16* __restrict__ vbuf,
        const int* __restrict__ offsets, int offset0,
        float* __restrict__ pm, float* __restrict__ pl,
        float* __restrict__ pacc, int Lq, int T,
        int H, int64_t qsb, int64_t qsl, int64_t qsh, int64_t ksb,
        int64_t ksl, int64_t ksh, int64_t vsb, int64_t vsl, int64_t vsh,
        float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* const sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const sv = sk + kBf16Stages * kBf16Tile * kHeadDim;

  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int bb = bh / H, hh = bh % H;
  const int off = offsets != nullptr ? offsets[bb] : offset0;
  int k_lo, k_hi;
  split_range(off, Lq, T, split, S, k_lo, k_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBf16Tile - 1) / kBf16Tile
                                  : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // tile -> stage: 1,024 16-byte chunks of K and as many of V, 8 + 8 a
  // thread; chunk c of row r lands at c ^ (r & 7); rows past the range
  // are zero-filled without a read
  const __nv_bfloat16* const kp = kbuf + bb * ksb + hh * ksh;
  const __nv_bfloat16* const vp = vbuf + bb * vsb + hh * vsh;
  auto load_tile = [&](int tile, int stage) {
    const int base = k_lo + tile * kBf16Tile;
#pragma unroll
    for (int u = 0; u < kBf16Tile * 16 / kBf16Threads; ++u) {
      const int i = tid + kBf16Threads * u;
      const int row = i >> 4, c = i & 15;
      const int key = base + row;
      const int64_t src = key < k_hi ? key : k_lo;
      const int dst =
          (stage * kBf16Tile + row) * kHeadDim + ((c ^ (row & 7)) << 3);
      const int bytes = key < k_hi ? 16 : 0;
      evo::cp_async16_zfill(sk + dst, kp + src * ksl + (c << 3), bytes);
      evo::cp_async16_zfill(sv + dst, vp + src * vsl + (c << 3), bytes);
    }
  };
#pragma unroll
  for (int st = 0; st < kBf16Stages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    evo::cp_async_commit();
  }

  // the query rows as the A operand of 8 k-steps; rows past Lq are zeros
  uint32_t qa[8][4];
  {
    const __nv_bfloat16* const qp = q + bb * qsb + hh * qsh + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), col = 16 * j + 8 * (i >> 1);
        qa[j][i] = r < Lq ? *reinterpret_cast<const uint32_t*>(
                                qp + r * qsl + col)
                          : 0u;
      }
  }
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // ldmatrix rows of this lane: K (matrices: keys 0-7 / 8-15 by lane >> 4,
  // the k-step's two 8-column halves by bit 3), V (keys by bit 3, the
  // n-tile pair's two tiles by lane >> 4)
  const int krow = 16 * warp + (lane & 7) + ((lane >> 4) << 3);
  const int vrow = 16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int khalf = (lane >> 3) & 1, vhalf = lane >> 4, sw = lane & 7;

  for (int it = 0; it < n_tiles; ++it) {
    evo::cp_async_wait<kBf16Stages - 2>();
    __syncthreads();  // tile it is in; every warp is done with it - 1
    if (it + kBf16Stages - 1 < n_tiles)
      load_tile(it + kBf16Stages - 1, (it + kBf16Stages - 1) % kBf16Stages);
    evo::cp_async_commit();
    const int stage = it % kBf16Stages;
    const uint32_t kbase =
        evo_sm90::smem_u32(sk + stage * kBf16Tile * kHeadDim);
    const uint32_t vbase =
        evo_sm90::smem_u32(sv + stage * kBf16Tile * kHeadDim);

    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, kbase + (krow * kHeadDim +
                              (((2 * j + khalf) ^ sw) << 3)) * 2);
      mma_16816(s[0], qa[j], b[0], b[1]);
      mma_16816(s[1], qa[j], b[2], b[3]);
    }

    const int key0 = k_lo + it * kBf16Tile + 16 * warp + 2 * t;
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lim = off + g + 8 * h;  // row g + 8h sees keys <= lim
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * nt + e;
          const float x = (key < k_hi && key <= lim)
                              ? s[nt][2 * h + e] * scale_log2
                              : -INFINITY;
          s[nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const bool finite = m_new != -INFINITY;
      const float m_safe = finite ? m_new : 0.f;
      const float alpha = finite ? evo_sm90::ex2(m[h] - m_safe) : 1.f;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = evo_sm90::ex2(s[nt][2 * h + e] - m_safe);
          rs += x;
          p[nt][2 * h + e] = x;
        }
      l[h] = l[h] * alpha + rs;  // this lane's keys; summed at the end
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    const uint32_t pa[4] = {
        evo::pack_bf16(p[0][0], p[0][1]), evo::pack_bf16(p[0][2], p[0][3]),
        evo::pack_bf16(p[1][0], p[1][1]), evo::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int n = 0; n < 16; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vbase + (vrow * kHeadDim +
                                    (((n + vhalf) ^ sw) << 3)) * 2);
      mma_16816(o[n], pa, b[0], b[1]);
      mma_16816(o[n + 1], pa, b[2], b[3]);
    }
  }
  evo::cp_async_wait<0>();
  __syncthreads();  // the stages become the warps' partials

  float* const wacc = reinterpret_cast<float*>(smem);  // [warp][16][128]
  float* const wm = wacc + kBf16Warps * kBf16Rows * kHeadDim;  // [warp][16]
  float* const wl = wm + kBf16Warps * kBf16Rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = g + 8 * h;
    if (t == 0) {
      wm[warp * kBf16Rows + r] = m[h];
      wl[warp * kBf16Rows + r] = l[h];
    }
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(
          &wacc[(warp * kBf16Rows + r) * kHeadDim + 8 * n + 2 * t]) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
  __syncthreads();
  const int d = tid % kHeadDim;  // one column of the head a thread
  for (int r = tid / kHeadDim; r < Lq; r += kBf16Threads / kHeadDim) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kBf16Warps; ++w)
      M = fmaxf(M, wm[w * kBf16Rows + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kBf16Warps; ++w) {
      const float mw = wm[w * kBf16Rows + r];
      const float wgt = mw == -INFINITY ? 0.f : evo_sm90::ex2(mw - M);
      L = fmaf(wgt, wl[w * kBf16Rows + r], L);
      A = fmaf(wgt, wacc[(w * kBf16Rows + r) * kHeadDim + d], A);
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
  // unrolled so that a row's S loads are in flight together
#pragma unroll 8
  for (int s = 0; s < S; ++s) M = fmaxf(M, m[s]);
  float L = 0.f, A = 0.f;
#pragma unroll 8
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
                 const void* vs, const void* offsets, int offset0, void* m,
                 void* l, void* acc, int B, int Lq, int T, int H,
                 long long qsb, long long qsl, long long qsh, long long ksb,
                 long long ksl, long long ksh, long long vsb, long long vsl,
                 long long vsh, int S, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, S);
  flash_buffer_q8_split_kernel<R><<<grid, kSplitThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v,
      (const float*)ks, (const float*)vs, (const int*)offsets, offset0,
      (float*)m, (float*)l, (float*)acc, Lq, T, H, qsb, qsl, qsh, ksb, ksl,
      ksh, vsb, vsl, vsh, scale * 1.4426950408889634f);
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

// The same operands for Lq <= 16, split into S ranges sized on the device:
// writes the partials m, l (B, H, Lq, S) and acc (B, H, Lq, S, 128), fp32
// contiguous, for evo_combine_partials. With offsets null every row is at
// offset0 (an offset the caller holds as a number: no tensor to fill).
extern "C" int evo_flash_attention_buffer_bf16_split(
    const void* q, const void* k, const void* v, const void* offsets,
    int offset0, void* m, void* l, void* acc, int B, int Lq, int T, int H,
    long long qsb, long long qsl, long long qsh, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl,
    long long vsh, int S, float scale, void* stream) {
  if (Lq < 1 || Lq > kBf16Rows || S < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_buffer_bf16_split_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16SmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, S);
  flash_buffer_bf16_split_kernel<<<grid, kBf16Threads, kBf16SmemBytes,
                                   (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)offsets, offset0, (float*)m,
      (float*)l, (float*)acc, Lq, T, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb,
      vsl, vsh, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
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

// The same operands for Lq <= 4, split into S ranges sized on the device:
// writes the partials m, l (B, H, Lq, S) and acc (B, H, Lq, S, 128), fp32
// contiguous, for evo_combine_partials; offsets null: every row at offset0.
extern "C" int evo_flash_attention_buffer_q8_split(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* offsets, int offset0, void* m, void* l,
    void* acc, int B, int Lq, int T, int H, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, int S, float scale,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (Lq < 1 || Lq > kSplitMaxRows || S < 1)
    return (int)cudaErrorInvalidValue;
  if (Lq == 1)
    return launch_split<1>(q, k, v, ks, vs, offsets, offset0, m, l, acc, B,
                           Lq, T, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl,
                           vsh, S, scale, st);
  if (Lq == 2)
    return launch_split<2>(q, k, v, ks, vs, offsets, offset0, m, l, acc, B,
                           Lq, T, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl,
                           vsh, S, scale, st);
  return launch_split<kSplitMaxRows>(q, k, v, ks, vs, offsets, offset0, m, l,
                                     acc, B, Lq, T, H, qsb, qsl, qsh, ksb,
                                     ksl, ksh, vsb, vsl, vsh, S, scale, st);
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
