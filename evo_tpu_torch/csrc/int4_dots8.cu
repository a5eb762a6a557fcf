// Weight-only int4 matmul in 'dots8' mode, for up to 128 activation rows:
// each row of x is quantized to int8, then multiplied with the int4 weight
// in exact integer dots, one scale group of 128 rows at a time:
//
//   xs[m]    = max(max_k |x[m, k]| / 127, 1e-12)
//   xq[m, k] = clip(round_half_even(x[m, k] / xs[m]), -127, 127)
//   y[m, n]  = xs[m] * sum_g scales[g, n] * (xq[m, 128g:] . q[128g:, n])
//
// x (M, K) bf16 with K <= Kp (columns K..Kp-1 read as zeros), packed
// (Kp/2, N) int8 in the `pack_int4` layout (byte row j: natural row j in
// its low nibble stored as value + 8, row Kp/2 + j in its high nibble),
// scales (Kp/128, N) fp32, y (M, N) fp32 or bf16 (one rounding).
//
// Replaces: evo_tpu/ops/pallas_int4.py `_int4_kernel` in its mode 'dots8'
// (`:115-142`), called through `int4_matmul(mode='dots8')`. No model path
// of either package calls it.
//
// Bound on the card: bytes. At one row the weight's half a byte and its
// scales' 4 bytes per 128 weights are all there is to read, against 2
// integer operations a weight; at 128 rows the 12.9 G int8 operations of a
// 4096 x 12288 weight take 0.0065 ms at 1,979 TOPS, under the 0.0080 ms its
// bytes take.
//
// Two launches. `quantize_rows_kernel` (a block a row) writes the codes
// xq (M, Kp) int8, zeros past K, and the row scales xs (M) fp32. The
// product (`int4_dots8_kernel`) has the streaming design of kernel 8 at up
// to 4 rows (`int4_matmul.cu`): a block of 8 warps owns 512 columns and
// steps of 128 byte rows (scale groups t and T + t), the rows arriving by
// 16-byte cp.async copies in four stages of 32, one stage in flight while
// the last is worked on; warp w owns 128 columns, a lane 4, and half of
// each stage's rows; and a block owns MT rows of x (1, 2, 4 or 8). A
// lane reads a 32-bit word of 4 columns a row; four rows' words are
// transposed by byte permutes into a word of 4 rows a column, and the
// dots are dp4a's on it: the low nibbles as (w & 0x0f0f0f0f), which are
// q + 8, so 8 times the codes' sum comes off; the high ones as
// (w & 0xf0f0f0f0), signed bytes of 16 q, so the sum is divided by 16,
// exactly. Both are exact in int32. At a step's end the two halves' sums
// are added, each group's integer dot is scaled in float32 and the two
// groups added, (lo * s_t) + (hi * s_T+t); the steps of a block add up in
// order. The contraction is split over blocks (`steps` steps each) where
// the blocks of the columns and rows alone would leave the card idle: a
// split writes its float32 sums, and the last block of a tile to finish
// (an integer ticket) adds them in split order and multiplies by xs. So
// the result is bit-reproducible, and bit-equal to the plain version
// (`ops/int4.int4_matmul_dots8_plain`), which adds in the same order.

#include <cstdint>

#include "common.cuh"

namespace {

using evo::cp_async16_zfill;
using evo::cp_async_commit;
using evo::cp_async_wait;

constexpr int kBK = 128;          // byte rows of a step
constexpr int kCols = 512;        // columns of a block: 128 a warp, 4 a lane
constexpr int kRows = 32;         // byte rows of a stage
constexpr int kStages = kBK / kRows;
constexpr int kThreads = 256;     // 4 warps across the columns, 2 down
constexpr int kQThreads = 256;
constexpr int kSlots = 9;         // a lane's sums a row: 4 low, 4 high, codes

__device__ __forceinline__ void store_y(void* y, bool out_bf16, int64_t i,
                                        float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[i] = v;
}

// A block a row of x: its scale, then its codes over the whole Kp
__global__ void __launch_bounds__(kQThreads)
    quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                         int8_t* __restrict__ xq, float* __restrict__ xs,
                         int K, int Kp) {
  __shared__ float red[kQThreads / 32];
  __shared__ float scale;
  const int m = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* row = x + (int64_t)m * K;
  float amax = 0.f;
  for (int k = tid; k < K; k += kQThreads)
    amax = fmaxf(amax, fabsf(__bfloat162float(row[k])));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  if (tid == 0) {
    float a = red[0];
#pragma unroll
    for (int w = 1; w < kQThreads / 32; ++w) a = fmaxf(a, red[w]);
    scale = fmaxf(__fdiv_rn(a, 127.f), 1e-12f);
    xs[m] = scale;
  }
  __syncthreads();
  const float s = scale;
  int8_t* out = xq + (int64_t)m * Kp;
  for (int k = tid; k < Kp; k += kQThreads) {
    int q = 0;
    if (k < K) {
      q = __float2int_rn(__fdiv_rn(__bfloat162float(row[k]), s));
      q = min(127, max(-127, q));
    }
    out[k] = (int8_t)q;
  }
}

// Block (x, y, z): columns 512 x.., steps [y steps, (y + 1) steps) of the
// contraction, rows MT z.. of x
template <int MT>
__global__ void __launch_bounds__(kThreads)
    int4_dots8_kernel(const int8_t* __restrict__ xq,
                      const float* __restrict__ xs,
                      const int8_t* __restrict__ packed,
                      const float* __restrict__ scales, void* __restrict__ y,
                      float* __restrict__ part, int* __restrict__ counters,
                      int M, int Kp, int N, int steps, int vec,
                      int out_bf16) {
  // the step's byte rows, [row][512 bytes]; the step's codes of the
  // block's rows of x, [row of x][256]: columns 128 t.. (low nibbles), then
  // Kp/2 + 128 t.. (high nibbles); where the second half's sums meet the
  // first's, [warp % 4][row][slot][lane]
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* tile = smem;
  int8_t* xsm = reinterpret_cast<int8_t*>(smem + kBK * kCols);
  int* halves = reinterpret_cast<int*>(xsm + MT * 2 * kBK);
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.z * MT;
  const int T = Kp / 256;
  const int split = blockIdx.y, splits = gridDim.y;
  const int t0 = split * steps, t1 = min(T, t0 + steps);
  const int c0 = (warp & 3) * 128 + lane * 4;  // this lane's 4 columns
  const int n = n0 + c0;
  constexpr int kHalf = kRows / 2;  // rows of a stage a warp takes

  float run[MT][4];  // the block's sums of the steps so far (half 0)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) run[m][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int8_t* base = packed + (int64_t)t * kBK * N + n0;
    // stage st: byte rows 32 st.. of step t, one group of copies
    auto fetch = [&](int st) {
      for (int i = tid; i < kRows * (kCols / 16); i += kThreads) {
        const int r = st * kRows + i / (kCols / 16);
        const int c = (i % (kCols / 16)) * 16;
        const int8_t* src = base + (int64_t)r * N + c;
        const int valid = N - n0 - c;
        if (vec) {
          // N % 16 == 0: a chunk lies wholly inside the row or past it
          cp_async16_zfill(tile + r * kCols + c, valid > 0 ? src : packed,
                           valid > 0 ? 16 : 0);
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          for (int b = 0; b < 16 && b < valid; ++b)
            w[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
          *reinterpret_cast<uint4*>(tile + r * kCols + c) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      cp_async_commit();
    };
    __syncthreads();  // every warp is done with the last step's shared data
    fetch(0);
    for (int i = tid; i < MT * (2 * kBK / 4); i += kThreads) {
      const int m = i / (2 * kBK / 4), j = (i % (2 * kBK / 4)) * 4;
      const int k = t * kBK + j + (j < kBK ? 0 : Kp / 2 - kBK);
      *reinterpret_cast<int*>(xsm + m * 2 * kBK + j) =
          m0 + m < M ? *reinterpret_cast<const int*>(
                           xq + (int64_t)(m0 + m) * Kp + k)
                     : 0;
    }

    int alo[MT][4], ahi[MT][4], xsum[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xsum[m] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) alo[m][j] = ahi[m][j] = 0;
    }
#pragma unroll 1
    for (int st = 0; st < kStages; ++st) {
      if (st + 1 < kStages) {
        fetch(st + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // stage st (and the codes, at the first) is visible
      const int r0 = st * kRows + half * kHalf;  // row in the step
      const uint8_t* rows = tile + r0 * kCols + c0;
#pragma unroll
      for (int i4 = 0; i4 < kHalf; i4 += 4) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + i4 * kCols);
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(rows + (i4 + 1) * kCols);
        const uint32_t w2 =
            *reinterpret_cast<const uint32_t*>(rows + (i4 + 2) * kCols);
        const uint32_t w3 =
            *reinterpret_cast<const uint32_t*>(rows + (i4 + 3) * kCols);
        // byte j of row word r is column j: a word a column, row r in
        // byte r
        const uint32_t a01 = __byte_perm(w0, w1, 0x5140);
        const uint32_t b01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t a23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t b23 = __byte_perm(w2, w3, 0x7362);
        const uint32_t col[4] = {
            __byte_perm(a01, a23, 0x5410), __byte_perm(a01, a23, 0x7632),
            __byte_perm(b01, b23, 0x5410), __byte_perm(b01, b23, 0x7632)};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xl =
              *reinterpret_cast<const int*>(xsm + m * 2 * kBK + r0 + i4);
          const int xh = *reinterpret_cast<const int*>(xsm + m * 2 * kBK +
                                                       kBK + r0 + i4);
          xsum[m] = __dp4a(xl, 0x01010101, xsum[m]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            alo[m][j] = __dp4a(xl, (int)(col[j] & 0x0f0f0f0fu), alo[m][j]);
            ahi[m][j] = __dp4a(xh, (int)(col[j] & 0xf0f0f0f0u), ahi[m][j]);
          }
        }
      }
    }
    // the second half's sums go to the first through shared memory
    int* hw = halves + (warp & 3) * MT * kSlots * 32 + lane;
    if (half) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hw[(m * kSlots + j) * 32] = alo[m][j];
          hw[(m * kSlots + 4 + j) * 32] = ahi[m][j];
        }
        hw[(m * kSlots + 8) * 32] = xsum[m];
      }
    }
    __syncthreads();
    if (!half) {
      // low nibbles belong to scale group t, high ones to group T + t
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s_lo = n + j < N ? scales[(int64_t)t * N + n + j] : 0.f;
        const float s_hi =
            n + j < N ? scales[(int64_t)(T + t) * N + n + j] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int codes = xsum[m] + hw[(m * kSlots + 8) * 32];
          const int lo = alo[m][j] + hw[(m * kSlots + j) * 32] - 8 * codes;
          const int hi = (ahi[m][j] + hw[(m * kSlots + 4 + j) * 32]) / 16;
          const float p = __fadd_rn(__fmul_rn((float)lo, s_lo),
                                    __fmul_rn((float)hi, s_hi));
          run[m][j] = t == t0 ? p : __fadd_rn(run[m][j], p);
        }
      }
    }
  }

  if (splits == 1) {
    if (!half) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (m0 + m < M && n + j < N)
            store_y(y, out_bf16 != 0, (int64_t)(m0 + m) * N + n + j,
                    __fmul_rn(run[m][j], xs[m0 + m]));
    }
    return;
  }
  if (!half) {
    float* out = part + (int64_t)split * M * N;  // this split's sums
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + m < M && n + j < N)
          out[(int64_t)(m0 + m) * N + n + j] = run[m][j];
  }

  // the tile's last block to finish adds the splits' sums in order: the
  // barrier orders the block's stores before thread 0's release, whose
  // acquire side orders the last block's loads after every split's
  __syncthreads();
  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last = prev == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  constexpr int kAhead = 16;
  const int nc = n0 + 2 * tid;  // all threads, two columns each
  for (int m = m0; m < min(M, m0 + MT); ++m) {
    float v[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += kAhead) {
      float ps[kAhead][2];
#pragma unroll
      for (int s = 0; s < kAhead; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ps[s][e] = s0 + s < splits && nc + e < N
                         ? __ldcg(part + ((int64_t)(s0 + s) * M + m) * N +
                                  nc + e)
                         : 0.f;
#pragma unroll
      for (int s = 0; s < kAhead; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (s0 + s < splits)
            v[e] = s0 + s == 0 ? ps[s][e] : __fadd_rn(v[e], ps[s][e]);
    }
    const float scale = xs[m];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (nc + e < N)
        store_y(y, out_bf16 != 0, (int64_t)m * N + nc + e,
                __fmul_rn(v[e], scale));
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <int MT>
int launch_dots8(const void* xq, const void* xs, const void* packed,
                 const void* scales, void* y, void* part, void* counters,
                 int M, int Kp, int N, int steps, int out_bf16,
                 void* stream) {
  const int T = Kp / 256;
  const int splits = (T + steps - 1) / steps;
  if (splits > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = (N % 16 == 0) && ((uintptr_t)packed % 16 == 0);
  const int bytes = kBK * kCols + MT * 2 * kBK +
                    4 * MT * kSlots * 32 * (int)sizeof(int);
  auto kernel = int4_dots8_kernel<MT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kCols - 1) / kCols, splits, (M + MT - 1) / MT);
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)packed,
      (const float*)scales, y, (float*)part, (int*)counters, M, Kp, N, steps,
      vec, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16, contiguous, 1 <= M <= 128, K <= Kp, Kp a multiple of
// 256; packed: (Kp/2, N) int8, contiguous; scales: (Kp/128, N) fp32,
// contiguous; y: (M, N) fp32, or bf16 when out_bf16, contiguous; xq:
// (M, Kp) int8 and xs: (M) fp32, scratch the launch writes; `mt` (1, 2, 4
// or 8) rows of x a block, `steps` steps of 128 byte rows a block, so
// ceil(Kp / 256 / steps) splits of the contraction: with more than one,
// `part` holds splits x M x N fp32 and `counters` one zeroed int32 per
// (512 columns, mt rows), which the kernel leaves zeroed.
extern "C" int evo_int4_dots8_bf16(const void* x, const void* packed,
                                   const void* scales, void* y, void* xq,
                                   void* xs, void* part, void* counters,
                                   int M, int K, int Kp, int N, int mt,
                                   int steps, int out_bf16, void* stream) {
  if (K > Kp || Kp % 256 || M < 1 || M > 128 || steps < 1 ||
      (uintptr_t)xq % 4)
    return (int)cudaErrorInvalidValue;
  quantize_rows_kernel<<<M, kQThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, K, Kp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (mt) {
    case 1:
      return launch_dots8<1>(xq, xs, packed, scales, y, part, counters, M,
                             Kp, N, steps, out_bf16, stream);
    case 2:
      return launch_dots8<2>(xq, xs, packed, scales, y, part, counters, M,
                             Kp, N, steps, out_bf16, stream);
    case 4:
      return launch_dots8<4>(xq, xs, packed, scales, y, part, counters, M,
                             Kp, N, steps, out_bf16, stream);
    case 8:
      return launch_dots8<8>(xq, xs, packed, scales, y, part, counters, M,
                             Kp, N, steps, out_bf16, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
