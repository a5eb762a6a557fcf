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
// Two launches. `quantize_rows_kernel` (a block a row; 16-byte loads of x
// and 8-byte stores of codes where x's rows allow) writes the codes xq
// (M, Kp) int8, zeros past K, and the row scales xs (M) fp32, with IEEE
// divisions. The product has two designs, chosen by the caller by M
// (`ops/int4.DOTS8_STREAM_MAX`), each bit-equal to the plain version
// (`ops/int4.int4_matmul_dots8_plain`), which adds in its order:
//
// From 2 rows, the int8 tensor cores (`dots8_mma_kernel`): kernel 8's
// wgmma skeleton (`int4_matmul.cu`, shared through `int4_sm90.cuh`) on s8
// x s8 -> s32 products (`sm90.cuh` `WgmmaRsS8`). The operands are swapped:
// the weight's columns are wgmma's 64-row side (A, in registers) and x's
// codes, rows padded to n = 16, 32, 64 or 128 (zeros TMA fills), its N
// side (B, K-major in shared memory; n = 128 as two passes of 64 over each
// run of steps, the second reading the run's weight bytes again, from L2:
// the sums of 128 rows held at once left the consumers short of registers
// and spilling). A thread reads its own columns' bytes of four byte rows
// from the swizzled boxes and transposes them with byte permutes into
// words of four k a column, wgmma's fragment layout for 8-bit A; then each
// nibble becomes a signed byte of 16 q, exactly: the high ones as (w &
// 0xf0f0f0f0), the low ones, stored as q + 8, as ((w << 4) & 0xf0f0f0f0)
// ^ 0x80808080 (the top bit flipped makes q + 8 two's-complement q). A
// step of 128 byte rows is four slabs of k = 32 and two chains, the low
// nibbles against x's codes of group t and the high ones against those of
// group T + t, each an s32 sum overwritten at the step's first slab; the
// sums are divided by 16 (a shift, exact), and the step adds, in float32,
// p = (lo * s_t) + (hi * s_T+t) to the run of its block's steps of the
// tile (the first step sets it). One producer thread fills a ring of four
// stages by TMA (a step's byte rows in 128 x 128 boxes under the 128-byte
// swizzle, the two groups' scales, x's two 128-byte code slices); a
// weight TMA cannot take is copied by the producer's threads. The product
// is a programmatic dependent launch: its blocks start while the quantize
// launch runs, load their first weight bytes and wait for it
// (`griddepcontrol.wait`) before they read xq or xs. Blocks are
// persistent, one an SM, over equal runs of the (column tile, step) units
// (stream-K, `ops/int4.mma_plan`'s plan: 256 columns a block at n <= 32,
// 128 above), so the weight is read once whatever M; a tile whose steps
// fall to more than one block is added up, parts in block order, by its
// last block, then multiplied by xs; a whole tile's run is. No float
// atomics: bit-reproducible. x takes any K and alignment (the quantize
// launch reads it; TMA reads xq).
//
// At one row, streaming (`int4_dots8_kernel`, measured faster there):
// kernel 8's streaming design of `int4_matmul.cu`: a block of 8 warps owns
// 512 columns and steps of 128 byte rows (scale groups t and T + t), the
// rows arriving by 16-byte cp.async copies in four stages of 32, one stage
// in flight while the last is worked on; warp w owns 128 columns, a lane
// 4, and half of each stage's rows (the kernel keeps its MT rows of x a
// block as a parameter; MT = 1 is its one instance). A lane reads a 32-bit
// word of 4 columns a row; four rows' words are transposed by byte
// permutes into a word of 4 rows a column, and the dots are dp4a's on it:
// the low nibbles as (w & 0x0f0f0f0f), which are q + 8, so 8 times the
// codes' sum comes off; the high ones as (w & 0xf0f0f0f0), signed bytes of
// 16 q, so the sum is divided by 16, exactly. Both are exact in int32. At
// a step's end the two halves' sums are added, each group's integer dot is
// scaled in float32 and the two groups added, (lo * s_t) + (hi * s_T+t);
// the steps of a block add up in order. The contraction is split over
// blocks (`steps` steps each) where the blocks of the columns alone would
// leave the card idle: a split writes its float32 sums, and the last block
// of a tile to finish (an integer ticket) adds them in split order and
// multiplies by xs.
//
// Registers (ptxas -v, sm_90a, CUDA 12.8): `dots8_mma_kernel` 168 at n =
// 16, 32, 64 and 128, the cap of 384 threads a block, which also bounds
// the consumers after `setmaxnreg` (one pass over 128 rows spilled 20-56
// bytes); `int4_dots8_kernel<1>` 48; `quantize_rows_kernel` 30. No spills;
// each product kernel's 16-byte stack frame is the weight copy path's
// local array.

#include <cstdint>

#include "common.cuh"
#include "int4_sm90.cuh"
#include "sm90.cuh"

namespace {

using evo::cp_async16_zfill;
using evo::cp_async_commit;
using evo::cp_async_wait;
using evo_int4::kBK;
using evo_int4::store_cols;
using evo_int4::store_y;
using evo_int4::unit_block;
using evo_int4::unit_start;

// ---- the quantize launch, and the streaming design -----------------------

constexpr int kCols = 512;        // columns of a block: 128 a warp, 4 a lane
constexpr int kRows = 32;         // byte rows of a stage
constexpr int kStages = kBK / kRows;
constexpr int kThreads = 256;     // 4 warps across the columns, 2 down
constexpr int kQThreads = 256;
constexpr int kSlots = 9;         // a lane's sums a row: 4 low, 4 high, codes

// The code of v at row scale s: clip(round_half_even(v / s), +-127), an
// IEEE division as the plain version's
__device__ __forceinline__ uint32_t code_of(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return (uint32_t)(uint8_t)(int8_t)min(127, max(-127, q));
}

// A block a row of x: its scale, then its codes over the whole Kp. `vec`
// (x 16-byte aligned, K % 8 == 0): a thread reads 8 values a load and
// writes their 8 codes in one store; else one value at a time
__global__ void __launch_bounds__(kQThreads)
    quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                         int8_t* __restrict__ xq, float* __restrict__ xs,
                         int K, int Kp, int vec) {
  // the product launch may start now (programmatic dependent launch): it
  // waits for this launch's end before it reads xq or xs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float red[kQThreads / 32];
  __shared__ float scale;
  const int m = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* row = x + (int64_t)m * K;
  const uint4* row8 = reinterpret_cast<const uint4*>(row);
  float amax = 0.f;
  if (vec) {
    for (int c = tid; c < K / 8; c += kQThreads) {
      const uint4 v = row8[c];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
  } else {
    for (int k = tid; k < K; k += kQThreads)
      amax = fmaxf(amax, fabsf(__bfloat162float(row[k])));
  }
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
  if (vec) {
    // Kp and xq's rows are multiples of 8: zeros past K in whole chunks
    for (int c = tid; c < Kp / 8; c += kQThreads) {
      uint32_t b[2] = {0u, 0u};
      if (c < K / 8) {
        const uint4 v = row8[c];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          b[e >> 1] |= (code_of(f.x, s) | code_of(f.y, s) << 8)
                       << (16 * (e & 1));
        }
      }
      reinterpret_cast<uint2*>(out)[c] = make_uint2(b[0], b[1]);
    }
  } else {
    for (int k = tid; k < Kp; k += kQThreads)
      out[k] = (int8_t)(k < K ? code_of(__bfloat162float(row[k]), s) : 0u);
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


// ---- the int8 tensor cores -----------------------------------------------

// The wgmma design's instance for x's rows padded to NI: TM 64-column tiles
// a consumer warpgroup, two consumer warpgroups a block (kBN columns);
// products of kNW rows (wgmma's N) in kNP passes over a block's segment of
// a tile (NI = 128: two of 64, since the sums of 128 rows in registers
// would leave too few for the rest: the consumers compile to 168 a
// thread); a ring of four stages. A stage holds one step of a pass as TMA
// writes it: x's two code slices (group t, then T + t), each kNW rows of
// 128 bytes under the 128-byte swizzle; the 128 byte rows of the block's
// columns in boxes of 128 columns under the same swizzle; the two groups'
// scales of the columns.
template <int NI>
struct Dots8Layout {
  static constexpr int kTM = NI <= 32 ? 2 : 1;
  static constexpr int kNW = NI < 64 ? NI : 64;
  static constexpr int kNP = NI / kNW;
  static constexpr int kStages = 4;
  static constexpr int kBN = 2 * kTM * 64;
  static constexpr int kSlice = kNW * 128;
  static constexpr int kXBytes = 2 * kSlice;
  static constexpr int kWBytes = kBN / 128 * evo_int4::kBox;
  static constexpr int kScales = kXBytes + kWBytes;  // offset
  static constexpr int kStageBytes =
      (kScales + 2 * kBN * 4 + 1023) / 1024 * 1024;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
};

// A thread's 2 TM bytes of one byte row
template <int TM>
__device__ __forceinline__ uint32_t row_bytes(const uint8_t* p) {
  if constexpr (TM == 1)
    return *reinterpret_cast<const uint16_t*>(p);
  else
    return *reinterpret_cast<const uint32_t*>(p);
}

// Four byte rows' words of a thread's 2 TM columns (column c in byte c)
// -> a word a column, byte e from row e
template <int TM>
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&c)[2 * TM]) {
  const uint32_t a01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t a23 = __byte_perm(w[2], w[3], 0x5140);
  c[0] = __byte_perm(a01, a23, 0x5410);
  c[1] = __byte_perm(a01, a23, 0x7632);
  if constexpr (TM == 2) {
    const uint32_t b01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t b23 = __byte_perm(w[2], w[3], 0x7362);
    c[2] = __byte_perm(b01, b23, 0x5410);
    c[3] = __byte_perm(b01, b23, 0x7632);
  }
}

// Four packed bytes -> four signed bytes of 16 q: of the low nibbles
// (stored as q + 8; the flipped top bit makes them two's complement), of
// the high ones (two's complement already)
__device__ __forceinline__ uint32_t low_x16(uint32_t w) {
  return ((w << 4) & 0xf0f0f0f0u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t high_x16(uint32_t w) {
  return w & 0xf0f0f0f0u;
}

// wgmma's A fragments of slab j (byte rows 32 j..) for a thread's TM
// tiles, low and high nibbles. A fragment holds rows g and g + 8 of its
// warp's 16, k (4 tq, +3) and (16 + 4 tq, +3); row g of tile i is the
// thread's column 2 i and row g + 8 column 2 i + 1. The thread's bytes of
// byte row 32 j + 4 tq + e (+ 16) lie at wd + 128 (its row) + 16 (its
// column's chunk `ck` ^ e) + its column's byte: rows 4 tq.. of a slab
// share the swizzle of rows e, which `ck` holds (made once, per load the
// rest: fewer live registers)
template <int TM>
__device__ __forceinline__ void convert_slab(const uint8_t* wd, int ck,
                                             int j,
                                             uint32_t (&fl)[TM][4],
                                             uint32_t (&fh)[TM][4]) {
  uint32_t ca[2 * TM], cb[2 * TM], w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = row_bytes<TM>(wd + ((ck ^ e) << 4) + (32 * j + e) * 128);
  transpose4<TM>(w, ca);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = row_bytes<TM>(wd + ((ck ^ e) << 4) + (32 * j + 16 + e) * 128);
  transpose4<TM>(w, cb);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    fl[i][0] = low_x16(ca[2 * i]);
    fl[i][1] = low_x16(ca[2 * i + 1]);
    fl[i][2] = low_x16(cb[2 * i]);
    fl[i][3] = low_x16(cb[2 * i + 1]);
    fh[i][0] = high_x16(ca[2 * i]);
    fh[i][1] = high_x16(ca[2 * i + 1]);
    fh[i][2] = high_x16(cb[2 * i]);
    fh[i][3] = high_x16(cb[2 * i + 1]);
  }
}

// The products of slabs J0..J1 - 1 against both slices at `st`: d += A B,
// or d = A B by slab 0
template <int NI, int TM, int NW, int J0, int J1>
__device__ __forceinline__ void issue_slabs(int (&lo)[TM][NW / 2],
                                            int (&hi)[TM][NW / 2],
                                            uint32_t (&fl)[4][TM][4],
                                            uint32_t (&fh)[4][TM][4],
                                            const uint8_t* st) {
  const uint64_t base = evo_sm90::sw128_desc(st, 16, 1024);
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    // a descriptor holds the address in 16-byte units
    const uint64_t dl = base + 2 * j;
    const uint64_t dh = base + (Dots8Layout<NI>::kSlice + 32 * j) / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      evo_sm90::WgmmaRsS8<NW>::run(lo[i], fl[j][i], dl, j > 0);
      evo_sm90::WgmmaRsS8<NW>::run(hi[i], fh[j][i], dh, j > 0);
    }
  }
}

// Registers that an asynchronous wgmma reads or writes: after a wait, so
// that the compiler neither reads them before it nor reuses them earlier
template <int A, int B>
__device__ __forceinline__ void fence_ints(int (&d)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

template <int TM>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][TM][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(f[j][i][e])::"memory");
}

// Block b of G takes the units [b U / G, (b + 1) U / G) of the U = tiles x
// T units (column tile, step), tile by tile: a run of a tile's steps is a
// segment, run kNP times, once for each kNW of x's rows. A segment that
// is the whole tile writes y = run * xs; else it writes its part, and the
// tile's last contributor in block order (`unit_block`) adds the parts in
// that order at the end of its range and multiplies by xs. Warpgroup 0 is
// the producer (setmaxnreg 40): one thread fills the ring by TMA, a
// step's byte rows, scales and x's code slices counted in bytes on the
// stage's `full` barrier (zeros past N and M); a weight TMA cannot take is
// copied by all its threads instead. It waits for the quantize launch
// (`griddepcontrol.wait`: the product may start under programmatic
// dependent launch) only before its first load of x's codes. Warpgroups 1
// and 2 are the consumers (setmaxnreg 232, though ptxas still fits their
// code in 168), TM tiles each: per step, the A fragments of slabs 0 and 1
// are made and their products issued, then those of slabs 2 and 3 made
// while the first run; each consumer warp releases the stage on `empty`
// once its products are done.
template <int NI>
__global__ void __launch_bounds__(evo_int4::kThreads, 1)
    dots8_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap smap,
                     const float* __restrict__ xs,
                     const int8_t* __restrict__ packed,
                     const float* __restrict__ scales, void* __restrict__ y,
                     float* __restrict__ part, int* __restrict__ counters,
                     int M, int Kp, int N, int tma_w, int out_bf16) {
  using Lay = Dots8Layout<NI>;
  constexpr int TM = Lay::kTM, NW = Lay::kNW, NP = Lay::kNP;
  constexpr int S = Lay::kStages, BN = Lay::kBN;
  constexpr int kP = evo_int4::kProducers, kC = evo_int4::kConsumers;
  extern __shared__ uint8_t dsm_raw[];
  // the swizzle atoms need 1024-byte alignment
  uint8_t* const ring =
      dsm_raw + ((1024 - (evo_sm90::smem_u32(dsm_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[S], empty[S];

  const int T = Kp / 256;
  const int tiles = (N + BN - 1) / BN;
  const int U = tiles * T, G = gridDim.x;
  const int u_begin = unit_start(blockIdx.x, U, G);
  const int u_end = unit_start(blockIdx.x + 1, U, G);
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      evo_sm90::mbar_init(&full[s], 1);
      evo_sm90::mbar_init(&empty[s], kC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kP) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tma_w && tid) return;
    bool waited = false;  // for the quantize launch's codes
    int q = 0;  // position in the ring
    for (int u = u_begin; u < u_end;) {
      const int n0 = u / T * BN;
      const int t0 = u % T, t1 = min(T, t0 + u_end - u);
      u += t1 - t0;
      for (int pass = 0; pass < NP; ++pass) {
        for (int t = t0; t < t1; ++t, ++q) {
          const int s = q % S;
          if (q >= S) evo_sm90::mbar_wait(&empty[s], ((q / S) & 1) ^ 1);
          uint8_t* const st = ring + s * Lay::kStageBytes;
          uint8_t* const wd = st + Lay::kXBytes;
          float* const sd = reinterpret_cast<float*>(st + Lay::kScales);
          if (!tma_w) {
            evo_int4::copy_step<kP>(wd, sd, packed, scales, t, T, N, n0,
                                    BN, tid);
            if (tid) continue;
          }
          evo_sm90::mbar_expect_tx(
              &full[s], Lay::kXBytes +
                            (tma_w ? Lay::kWBytes + 2 * BN * 4 : 0));
          if (tma_w) {
#pragma unroll
            for (int b = 0; b < BN / 128; ++b)
              evo_sm90::tma_load_2d(wd + b * evo_int4::kBox, &wmap,
                                    &full[s], n0 + 128 * b, t * kBK);
            evo_sm90::tma_load_2d(sd, &smap, &full[s], n0, t);
            evo_sm90::tma_load_2d(sd + BN, &smap, &full[s], n0, T + t);
          }
          // x's codes of groups t and T + t: columns 128 t.. and Kp/2 +
          // 128 t.., the pass's rows
          if (!waited) {
            asm volatile("griddepcontrol.wait;\n" ::: "memory");
            waited = true;
          }
          evo_sm90::tma_load_2d(st, &xmap, &full[s], t * kBK, pass * NW);
          evo_sm90::tma_load_2d(st + Lay::kSlice, &xmap, &full[s],
                                Kp / 2 + t * kBK, pass * NW);
        }
      }
    }
    return;
  }

  // the consumers: the row scales are the quantize launch's too
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int ctid = tid - kP;
  const int wg = ctid >> 7, wi = (ctid >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's 2 TM columns of the block: byte 2 i + h is tile i's
  // fragment row g + 8 h; its byte rows 4 tq.. in a stage's boxes, and
  // its chunk there under the swizzle of row 4 tq (`convert_slab`)
  const int cb = wg * TM * 64 + wi * 16 * TM + g * 2 * TM;
  const int wrow = Lay::kXBytes + (cb >> 7) * evo_int4::kBox + (cb & 15) +
                   4 * tq * 128;
  const int ck = ((cb & 127) >> 4) ^ (4 * (tq & 1));
  const bool vec_out = N % (2 * TM) == 0;
  float run[TM][NW / 2];
  int lo[TM][NW / 2], hi[TM][NW / 2];
  uint32_t fl[4][TM][4], fh[4][TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) lo[i][j] = hi[i][j] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) fl[j][i][e] = fh[j][i][e] = 0u;

  int q = 0;
  // tiles whose parts this block adds (only a block's first segment can
  // end a tile that it did not begin, so held1 stays -1)
  int held0 = -1, held1 = -1;
  for (int u = u_begin; u < u_end;) {
    const int tile = u / T, n0 = tile * BN, n = n0 + cb;
    const int t0 = u % T, t1 = min(T, t0 + u_end - u);
    u += t1 - t0;
    // contributors to the tile: blocks b0 .. b1
    const bool whole = t0 == 0 && t1 == T;
    const int b0 = unit_block(tile * T, U, G);
    const int b1 = unit_block(tile * T + T - 1, U, G);
    for (int pass = 0; pass < NP; ++pass) {
      for (int t = t0; t < t1; ++t, ++q) {
        const int s = q % S;
        evo_sm90::mbar_wait(&full[s], (q / S) & 1);
        const uint8_t* const st = ring + s * Lay::kStageBytes;
        // low nibbles belong to scale group t, high ones to group T + t
        const float* const sc =
            reinterpret_cast<const float*>(st + Lay::kScales) + cb;
        // slabs 0 and 1 made and their products issued, then slabs 2 and
        // 3 made while those run
        convert_slab<TM>(st + wrow, ck, 0, fl[0], fh[0]);
        convert_slab<TM>(st + wrow, ck, 1, fl[1], fh[1]);
        evo_sm90::wgmma_fence();
        issue_slabs<NI, TM, NW, 0, 2>(lo, hi, fl, fh, st);
        evo_sm90::wgmma_commit();
        convert_slab<TM>(st + wrow, ck, 2, fl[2], fh[2]);
        convert_slab<TM>(st + wrow, ck, 3, fl[3], fh[3]);
        evo_sm90::wgmma_fence();
        issue_slabs<NI, TM, NW, 2, 4>(lo, hi, fl, fh, st);
        evo_sm90::wgmma_commit();
        evo_sm90::wgmma_wait<0>();
        fence_frags(fl);
        fence_frags(fh);
        fence_ints(lo);
        fence_ints(hi);
        // element j of tile i: x row 8 (j / 4) + 2 tq + (j & 1) of the
        // pass's, the thread's column 2 i + (j / 2) % 2
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < NW / 2; ++j) {
            const int c = 2 * i + ((j >> 1) & 1);
            const float p =
                __fadd_rn(__fmul_rn((float)(lo[i][j] >> 4), sc[c]),
                          __fmul_rn((float)(hi[i][j] >> 4), sc[BN + c]));
            run[i][j] = t == t0 ? p : __fadd_rn(run[i][j], p);
          }
        // every thread of the warp is done with stage s
        __syncwarp();
        if (lane == 0) evo_sm90::mbar_arrive(&empty[s]);
      }

      // the pass's rows of y = run * xs, or of this block's part
      float* const dst = part + (int64_t)(blockIdx.x - b0) * M * N;
#pragma unroll
      for (int jj = 0; jj < NW / 8; ++jj)
#pragma unroll
        for (int lo2 = 0; lo2 < 2; ++lo2) {
          const int m = NW * pass + 8 * jj + 2 * tq + lo2;
          if (m < M && n < N) {
            float v[2 * TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                v[2 * i + hh] = run[i][4 * jj + 2 * hh + lo2];
            if (whole) {
              const float r = xs[m];
#pragma unroll
              for (int e = 0; e < 2 * TM; ++e) v[e] = __fmul_rn(v[e], r);
              store_cols<TM>(y, out_bf16 != 0, (int64_t)m * N + n, v, N - n,
                             vec_out);
            } else {
              store_cols<TM>(dst, false, (int64_t)m * N + n, v, N - n,
                             vec_out);
            }
          }
        }
    }
    if (whole) continue;
    if (blockIdx.x == b1) {
      // the tile's last contributor adds the parts once its own range is
      // done (a block's first segment ends a tile, its last begins one)
      (held0 < 0 ? held0 : held1) = tile;
    } else {
      // this part is written: each warp counts itself on the tile's ticket
      __syncwarp();
      if (lane == 0)
        asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(
                         counters + tile)
                     : "memory");
    }
  }

  // the tiles this block ends: once the lower blocks' warps have counted
  // their parts (they were placed on SMs before this one, so waiting for
  // them cannot stall them), their sum in block order times xs is y
  for (int r = 0; r < 2; ++r) {
    const int tile = r ? held1 : held0;
    if (tile < 0) continue;
    const int b0 = unit_block(tile * T, U, G);
    const int parts = blockIdx.x - b0 + 1;
    if (ctid == 0) {
      const int want = (parts - 1) * (kC / 32);
      int got;
      do {
        asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                     : "=r"(got)
                     : "l"(counters + tile)
                     : "memory");
      } while (got < want);
      counters[tile] = 0;  // ready for the next launch
    }
    __threadfence();  // this block's own part, for the loads below
    asm volatile("bar.sync 1, %0;\n" ::"n"(kC) : "memory");
    if (N % 4 == 0)
      evo_int4::combine_parts<4>(part, y, out_bf16 != 0, M, N, tile * BN, BN,
                                 parts, xs, ctid);
    else
      evo_int4::combine_parts<1>(part, y, out_bf16 != 0, M, N, tile * BN, BN,
                                 parts, xs, ctid);
  }
}

// 1: the product launch may overlap the quantize launch (programmatic
// dependent launch); 0: it waits for its end, as a plain launch does
constexpr int kPdl = 1;

template <int NI>
int launch_dots8_mma(const void* xq, const void* xs, const void* packed,
                     const void* scales, void* y, void* part, void* counters,
                     int M, int Kp, int N, int blocks, int out_bf16,
                     void* stream) {
  using Lay = Dots8Layout<NI>;
  const int U = (N + Lay::kBN - 1) / Lay::kBN * (Kp / 256);
  if ((uintptr_t)xq % 16 || blocks < 1 || blocks > U || M > NI)
    return (int)cudaErrorInvalidValue;
  // a tile is split unless every block's units are whole tiles
  if (U % blocks || (U / blocks) % (Kp / 256)) {
    if (part == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  // x's codes as slices of 128 bytes x kNW rows (zeros past M)
  CUtensorMap xm, wm, sm;
  CUresult r = evo_int4::cached_map(&xm, xq, M, Kp,
                                    CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128,
                                    Lay::kNW, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return evo_sm90::kEncodeError + (int)r;
  int tma_w = 0;
  r = evo_int4::weight_maps(&wm, &sm, packed, scales, Kp, N, Lay::kBN,
                            &tma_w);
  if (r != CUDA_SUCCESS) return evo_sm90::kEncodeError + (int)r;
  auto kernel = dots8_mma_kernel<NI>;
  static uint64_t configured = 0;  // a bit a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(configured >> (dev & 63) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << (dev & 63);
  }
  // programmatic dependent launch: the blocks may start while the quantize
  // launch runs, and wait for it where they read its output
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(evo_int4::kThreads);
  cfg.dynamicSmemBytes = Lay::kSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = kPdl;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, xm, wm, sm, (const float*)xs, (const int8_t*)packed,
      (const float*)scales, y, (float*)part, (int*)counters, M, Kp, N, tma_w,
      out_bf16);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16, contiguous, 1 <= M <= 128, K <= Kp, Kp a multiple of
// 256; packed: (Kp/2, N) int8, contiguous; scales: (Kp/128, N) fp32,
// contiguous; y: (M, N) fp32, or bf16 when out_bf16, contiguous; xq:
// (M, Kp) int8, 16-byte aligned, and xs: (M) fp32, scratch the launch
// writes. `blocks` > 0 picks the int8 tensor cores' design on that many
// persistent blocks (`ops/int4.mma_plan`); else the streaming design (M =
// 1), `steps` steps of 128 byte rows a block, so ceil(Kp / 256 / steps)
// splits of the contraction. With more than one split or contributor to a
// tile, `part` holds that many x M x N fp32 and `counters` one zeroed
// int32 a tile (512 columns, or the wgmma instance's), which the kernel
// leaves zeroed.
extern "C" int evo_int4_dots8_bf16(const void* x, const void* packed,
                                   const void* scales, void* y, void* xq,
                                   void* xs, void* part, void* counters,
                                   int M, int K, int Kp, int N, int steps,
                                   int blocks, int out_bf16, void* stream) {
  if (K > Kp || Kp % 256 || M < 1 || M > 128 || (uintptr_t)xq % 16 ||
      (blocks < 1 && steps < 1))
    return (int)cudaErrorInvalidValue;
  const int vec = K % 8 == 0 && (uintptr_t)x % 16 == 0;
  quantize_rows_kernel<<<M, kQThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, K, Kp, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) {
    if (M <= 16)
      return launch_dots8_mma<16>(xq, xs, packed, scales, y, part, counters,
                                  M, Kp, N, blocks, out_bf16, stream);
    if (M <= 32)
      return launch_dots8_mma<32>(xq, xs, packed, scales, y, part, counters,
                                  M, Kp, N, blocks, out_bf16, stream);
    if (M <= 64)
      return launch_dots8_mma<64>(xq, xs, packed, scales, y, part, counters,
                                  M, Kp, N, blocks, out_bf16, stream);
    return launch_dots8_mma<128>(xq, xs, packed, scales, y, part, counters,
                                 M, Kp, N, blocks, out_bf16, stream);
  }
  if (M != 1) return (int)cudaErrorInvalidValue;
  return launch_dots8<1>(xq, xs, packed, scales, y, part, counters, M, Kp, N,
                         steps, out_bf16, stream);
}
