// Weight-only int4 matmul with group-128 scales, for up to 128 activation
// rows:
//
//   y[m, n] = sum_g scales[g, n] *
//             ( x[m, 128g:128(g+1)] . unpack(packed)[128g:128(g+1), n] )
//
// x (M, K) bf16 with K <= Kp (columns K..Kp-1 read as zeros), packed
// (Kp/2, N) int8, scales (Kp/128, N) fp32, y (M, N) fp32 or bf16 (one
// round-to-nearest of the float32 sum); Kp is a multiple of 256. Byte row
// j of `packed` holds natural row j in its low nibble, stored as value + 8,
// and natural row Kp/2 + j in its high nibble in two's complement (the
// `pack_int4` layout, in which weights cross between the two packages).
//
// Replaces: evo_tpu/ops/pallas_int4.py `_int4_kernel` in its modes
// 'unroll' (the default) and 'dots', which compute this one function, and,
// as the instance with kBlock set, in its mode 'block': there each weight
// is dequantized and rounded to bf16, w = bf16(q * s), and the products
// of x with w are summed in float32 with no scale after the sum (the JAX
// test's `_oracle_block`). Called through `int4_matmul(mode=...)`. One
// launch per quantized projection of a decode step: five a layer, 160 a
// step of evo-1. ('dots8' is another function: `int4_dots8.cu`.)
//
// Bound on the card: bytes at decode, operations near 128 rows. A call
// reads every packed weight once, half a byte per weight plus 4 bytes of
// scale per 128 of them, and computes 2 * M operations per weight: at 4096
// x 12288 the bytes take 0.0080 ms at 3.35 TB/s, and the operations pass
// them (0.0130 ms at 989 TFLOP/s) only from M = 80 on.
//
// Two designs, chosen by the caller by M (`ops/int4.GEMV_M_MAX`):
//
// M <= 2 (decode; `int4_gemv_kernel`): a streaming design, no tensor
// cores. A block of 8 warps owns 512 columns and one step of 128 byte rows
// (scale groups t and T + t); the rows arrive by 16-byte cp.async copies
// (512 contiguous bytes a row) in four stages of 32 rows, one stage in
// flight while the last one is worked on. Warp w owns 128 of the columns,
// a lane 4, read from shared memory as one 32-bit word a row, and half of
// each stage's rows. Nibbles become float32 in registers without a
// permute: with the exponent bits of 2^(23 - p) around the nibble at bit p
// (one LOP3, which also flips the sign bit of a two's-complement nibble)
// the float is 2^(23 - p) + nibble, and one subtract leaves the value
// exactly; each weight then costs a LOP3, a subtract and M fused
// multiply-adds against x, broadcast from shared memory as float32 (bf16
// x int4 is exact in float32: only the sum rounds). At the step's end the
// two halves' sums of each group are added, multiplied by the group's
// scale and the two groups added, rounded apart as the plain version
// does. Each step is a split of the contraction (at 4096 x 12288: 24
// tiles x 16 splits); a split writes its partial sums, and the last block
// of a tile to finish (an integer ticket, no float atomics) adds them in
// split order, so a run is bit-reproducible. (A cluster of a tile's
// splits summing through distributed shared memory was slower: the
// clusters' placement cost more than the ticket's round trips.) It is the
// faster design up to 2 rows.
//
// M = 3..128 (`int4_mma_kernel`): the products on the tensor cores by
// wgmma, the operands swapped: y^T tiles = W^T x^T, so the weight's
// columns are wgmma's 64-row side and x's rows, padded to n = 16, 32, 64
// or 128 (zeros that TMA fills), its N side. The weights are dequantized
// in registers straight into wgmma's A fragments (register-A wgmma): a
// thread reads the packed bytes of its own fragment rows from shared
// memory, both rows of a fragment pair as one 16- or 32-bit load (the
// fragment rows are assigned to physical columns so that a thread's
// columns are adjacent; the epilogue undoes it), and turns each nibble
// into bf16 with a permute, a LOP3 and a bf16 subtract; there is no bf16
// copy of W in shared memory. x^T is wgmma's B, K-major, read from shared
// memory by the tensor cores. A block is one producer warpgroup (one
// thread issues TMA: the step's byte rows in 128 x 128 boxes under the
// 128-byte swizzle, the two groups' scales, x's two 128-column slices as
// four 64-column atoms, all counted in bytes on an mbarrier) and two
// consumer warpgroups of 128 or 256 columns in all, a ring of 2 to 4
// stages between them. Each step is two chains, the low nibbles (group t)
// against x's first slice and the high nibbles (group T + t) against the
// second, each a float32 dot overwritten at its group's start and added
// as acc += dot * scale when the next chain starts; 'block' scales the
// fragments instead (bf16(q * s)) and adds the dots as they are. The
// tensor maps (the weight's, its scales', x's) are encoded once a
// pointer and shape and kept. Blocks are persistent, one an SM: block b of G
// takes an equal run of the tiles' (column tile, step) units (stream-K),
// so every SM does the same work at every shape; a tile split between
// blocks is added up in block order by its last block at the end of that
// block's run, the others signalling with an integer count (no float
// atomics: bit-reproducible, and the counts are left at zero). This path
// needs K % 8 == 0 and a 16-byte aligned x (the wrapper pads otherwise);
// a weight TMA cannot take (N % 16 != 0, misaligned) is copied into the
// same layout by the producer warpgroup's threads.
//
// 'block' costs a multiply and a rounding to bf16 a weight more in both
// designs (in registers), and drops the scale from each group's sum.

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

// ---- M <= 2 -------------------------------------------------------------

constexpr int kGvCols = 512;   // columns of a block: 128 a warp, 4 a lane
constexpr int kGvRows = 32;    // byte rows of a stage
constexpr int kGvStages = kBK / kGvRows;  // a step of 128 rows in 4 stages
constexpr int kGvThreads = 256;  // 4 warps across the columns, 2 down

// The nibble at bits P..P+3 of w as a float32 value, without a permute or
// a conversion: with the exponent bits of 2^(23 - P) around it the float
// is 2^(23 - P) + nibble, so one subtract leaves the value. `k` holds
// those exponent bits and, for a two's-complement nibble, its bit P + 3,
// which turns it into value + 8 first (the low nibbles are stored so).
// (w & mask) ^ k is written as one lop3 because a LOP3 takes one
// immediate: left to itself the compiler folds k into a second LOP3.
template <int P>
__device__ __forceinline__ float nibble_at(uint32_t w, uint32_t k) {
  constexpr float kOff = (float)(1 << (23 - P)) + 8.f;
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(r) : "r"(w), "n"(0xf << P),
      "r"(k));
  return __uint_as_float(r) - kOff;
}

// q * s rounded to bf16, as a float32 value ('block' mode)
__device__ __forceinline__ float scaled_bf16(float q, float s) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, s)));
}

// The k of `nibble_at<P>`
template <int P>
__device__ __forceinline__ uint32_t nibble_key(bool high) {
  return ((uint32_t)(150 - P) << 23) | (high ? 0x8u << P : 0u);
}

// A block: 512 columns x one step t = blockIdx.y (128 byte rows, scale
// groups t and T + t). Warp w owns columns 128 (w % 4).. and, of each
// stage of 32 rows, the half w / 4; M <= MT rows of x. kBlock: 'block'
// mode.
template <int MT, bool kBlock>
__global__ void __launch_bounds__(kGvThreads, 2)
    int4_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ packed,
                     const float* __restrict__ scales, void* __restrict__ y,
                     float* __restrict__ part, int* __restrict__ counters,
                     int M, int K, int Kp, int N, int vec, int out_bf16) {
  // the step's byte rows, [row][512 bytes], then its x as float32,
  // [row of x][256]: columns 128 t.. (low nibbles), then Kp/2 + 128 t..
  // (high nibbles), then where the second half's group sums meet the
  // first's, [warp % 4][row][low j, high j][lane]
  extern __shared__ __align__(16) unsigned char gsm[];
  uint8_t* tile = gsm;
  float* xs = reinterpret_cast<float*>(gsm + kBK * kGvCols);
  float* halves = xs + MT * 2 * kBK;
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2;
  const int n0 = blockIdx.x * kGvCols;
  const int T = Kp / 256, t = blockIdx.y;
  const int8_t* base = packed + (int64_t)t * kBK * N + n0;

  // stage st: byte rows 32 st.. of the step, one group of copies
  auto fetch = [&](int st) {
#pragma unroll
    for (int i = tid; i < kGvRows * (kGvCols / 16); i += kGvThreads) {
      const int r = st * kGvRows + i / (kGvCols / 16);
      const int c = (i % (kGvCols / 16)) * 16;
      const int8_t* src = base + (int64_t)r * N + c;
      const int valid = N - n0 - c;
      if (vec) {
        // N % 16 == 0: a chunk lies wholly inside the row or past it
        cp_async16_zfill(tile + r * kGvCols + c, valid > 0 ? src : packed,
                         valid > 0 ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int b = 0; b < 16 && b < valid; ++b)
          w[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
        *reinterpret_cast<uint4*>(tile + r * kGvCols + c) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  for (int i = tid; i < M * 2 * kBK; i += kGvThreads) {
    const int m = i / (2 * kBK), j = i % (2 * kBK);
    const int k = t * kBK + j + (j < kBK ? 0 : Kp / 2 - kBK);
    xs[i] = k < K ? __bfloat162float(x[(int64_t)m * K + k]) : 0.f;
  }

  // this lane's 4 columns in the tile
  const int c0 = (warp & 3) * 128 + lane * 4;
  const int n = n0 + c0;
  // low nibbles belong to scale group t, high ones to group T + t
  float sc[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[0][j] = n + j < N ? scales[(int64_t)t * N + n + j] : 0.f;
    sc[1][j] = n + j < N ? scales[(int64_t)(T + t) * N + n + j] : 0.f;
  }
  const int splits = gridDim.y;
  float* out = part + (int64_t)t * M * N;  // this split's partial sums
  const uint32_t k0 = nibble_key<0>(false);
  const uint32_t k4 = nibble_key<4>(true);
  const uint32_t k8 = nibble_key<8>(false);
  const uint32_t k12 = nibble_key<12>(true);
  const uint32_t k16 = nibble_key<16>(false);
  constexpr int kHalf = kGvRows / 2;  // rows of a stage a warp takes

  float plo[MT][4], phi[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) plo[m][j] = phi[m][j] = 0.f;
#pragma unroll 1
  for (int st = 0; st < kGvStages; ++st) {
    // one stage in flight while this one is worked on: the card's queue
    // stays short, so the stages land in order and the work follows the
    // copies (all four at once would land together, late)
    if (st + 1 < kGvStages) {
      fetch(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and x, at the first) is visible
    const int r0 = st * kGvRows + half * kHalf;  // row in the step
    const uint8_t* rows = tile + r0 * kGvCols + c0;
    const float* xw = xs + r0;
#pragma unroll
    for (int i4 = 0; i4 < kHalf; i4 += 4) {
      float xl[MT][4], xh[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const bool live = MT == 1 || m < M;
        const float4 a =
            live ? *reinterpret_cast<const float4*>(xw + m * 2 * kBK + i4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b =
            live ? *reinterpret_cast<const float4*>(xw + m * 2 * kBK +
                                                    kBK + i4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        xl[m][0] = a.x, xl[m][1] = a.y, xl[m][2] = a.z, xl[m][3] = a.w;
        xh[m][0] = b.x, xh[m][1] = b.y, xh[m][2] = b.z, xh[m][3] = b.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(rows + (i4 + r) * kGvCols);
        const uint32_t w2 = w >> 16;
        // byte j of w is column j: its low nibble at bit 8j, its high
        // one at 8j + 4; bits 20 and up go through w2 (the exponent bits
        // start at 23)
        const float vl[4] = {nibble_at<0>(w, k0), nibble_at<8>(w, k8),
                             nibble_at<16>(w, k16), nibble_at<8>(w2, k8)};
        const float vh[4] = {nibble_at<4>(w, k4), nibble_at<12>(w, k12),
                             nibble_at<4>(w2, k4), nibble_at<12>(w2, k12)};
        float wl[4], wh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wl[j] = kBlock ? scaled_bf16(vl[j], sc[0][j]) : vl[j];
          wh[j] = kBlock ? scaled_bf16(vh[j], sc[1][j]) : vh[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            // bf16 x int4 (or x bf16) is exact in float32: only the sum
            // rounds
            plo[m][j] = fmaf(xl[m][r], wl[j], plo[m][j]);
            phi[m][j] = fmaf(xh[m][r], wh[j], phi[m][j]);
          }
      }
    }
  }
  // the second half's sums go to the first through shared memory; the
  // group's sum is the first half's plus the second's
  float* hw = halves + (warp & 3) * MT * 8 * 32 + lane;
  if (half) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hw[(m * 8 + j) * 32] = plo[m][j];
        hw[(m * 8 + 4 + j) * 32] = phi[m][j];
      }
  }
  __syncthreads();
  if (!half) {
    // each group's sum times its scale, rounded apart as the plain
    // version does ('block': the two sums, the scales being in them);
    // with one split that is y, else this split's part
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = __fadd_rn(plo[m][j], hw[(m * 8 + j) * 32]);
        const float hi = __fadd_rn(phi[m][j], hw[(m * 8 + 4 + j) * 32]);
        const float v = kBlock ? __fadd_rn(lo, hi)
                               : __fadd_rn(__fmul_rn(lo, sc[0][j]),
                                           __fmul_rn(hi, sc[1][j]));
        if (m < M && n + j < N) {
          if (splits == 1)
            store_y(y, out_bf16 != 0, (int64_t)m * N + n + j, v);
          else
            out[(int64_t)m * N + n + j] = v;
        }
      }
  }
  if (splits == 1) return;

  // the tile's last block to finish adds the splits' parts in order: the
  // barrier orders the block's stores before thread 0's release, whose
  // acquire side orders the last block's loads after every part
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counters + blockIdx.x)
                 : "memory");
    last = prev == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  // all threads, two columns each: the loads of 16 splits are in flight
  // together, then added in split order
  constexpr int kAhead = 16;
  const int nc = n0 + 2 * tid;
  for (int m = 0; m < M; ++m) {
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
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (nc + e < N)
        store_y(y, out_bf16 != 0, (int64_t)m * N + nc + e, v[e]);
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <int MT, bool kBlock>
int launch_gemv(const void* x, const void* packed, const void* scales,
                void* y, void* part, void* counters, int M, int K, int Kp,
                int N, int out_bf16, void* stream) {
  const int splits = Kp / 256;
  if (splits > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = (N % 16 == 0) && ((uintptr_t)packed % 16 == 0);
  const int bytes =
      kBK * kGvCols + (MT * 2 * kBK + 4 * MT * 8 * 32) * (int)sizeof(float);
  auto kernel = int4_gemv_kernel<MT, kBlock>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kGvCols - 1) / kGvCols, splits);
  kernel<<<grid, kGvThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)packed, (const float*)scales,
      y, (float*)part, (int*)counters, M, K, Kp, N, vec, out_bf16);
  return (int)cudaGetLastError();
}

// ---- M = 3..128 ---------------------------------------------------------

// The nibbles in bits 0-3 and 16-19 of v as two bf16 values, without a
// conversion: 0x4300 | n is bf16(128 + n), and subtracting bf16(136) in
// bf16 is exact. `bits` 0x4300 takes a nibble stored as value + 8 (the low
// one); 0x4308 also flips bit 3, which turns a two's-complement nibble
// (the high one) into value + 8 first.
__device__ __forceinline__ uint32_t nibbles_to_bf16(uint32_t v,
                                                    uint32_t bits) {
  // (v & 0x000f000f) ^ (bits, twice) as one lop3
  uint32_t biased;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;"
      : "=r"(biased)
      : "r"(v), "n"(0x000f000f), "r"(bits | (bits << 16)));
  const uint32_t k136 = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
              *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A pair of bf16 weights times one scale, rounded to bf16 again ('block')
__device__ __forceinline__ uint32_t scale_pair(uint32_t pair, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  return evo::pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
}

// The wgmma design's instance for x's rows padded to NI (wgmma's N side):
// TM 64-column tiles a consumer warpgroup, two consumer warpgroups a block
// (kBN columns), a ring of kStages steps. A stage holds one step, as TMA
// writes it: x's two 128-column slices (low nibbles' groups, then high
// nibbles'), each as two atoms of 64 columns x NI rows under the 128-byte
// swizzle; the 128 byte rows of the block's columns in boxes of 128
// columns under the same swizzle (so the consumers' reads of four rows at
// once fall in distinct banks); the two groups' scales of the columns.
template <int NI>
struct MmaLayout {
  static constexpr int kTM = NI <= 32 ? 2 : 1;
  static constexpr int kStages = NI <= 64 ? 4 : 2;
  static constexpr int kBN = 2 * kTM * 64;
  static constexpr int kAtom = NI * 128;
  static constexpr int kXBytes = 4 * kAtom;
  static constexpr int kBox = evo_int4::kBox;  // a box of byte rows
  static constexpr int kWBytes = kBN / 128 * kBox;
  static constexpr int kScales = kXBytes + kWBytes;  // offset
  static constexpr int kStageBytes =
      (kScales + 2 * kBN * 4 + 1023) / 1024 * 1024;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
};

constexpr int kMmaProducers = evo_int4::kProducers;
constexpr int kMmaConsumers = evo_int4::kConsumers;
constexpr int kMmaThreads = evo_int4::kThreads;

// fence_regs for the accumulators and fragments of one warpgroup
template <int A, int B>
__device__ __forceinline__ void fence_tiles(float (&d)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
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

// A thread's 2 TM bytes of one byte row
template <int TM>
__device__ __forceinline__ uint32_t row_bytes(const uint8_t* p) {
  if constexpr (TM == 1)
    return *reinterpret_cast<const uint16_t*>(p);
  else
    return *reinterpret_cast<const uint32_t*>(p);
}

// wgmma's A fragments of four 16-row slabs (s0 / 16 ..) of one nibble (H:
// 0 low, 1 high) for a thread's TM tiles, straight from the packed bytes.
// A fragment holds rows g and g + 8 of its warp's 16, k pairs (2 tq, +1)
// and (2 tq + 8, +9); row g of tile i is byte 2 i of the thread's columns
// and row g + 8 byte 2 i + 1, so one permute takes both rows' bytes of two
// byte rows, and the bf16 conversion of `nibbles_to_bf16` the pairs along
// k. The thread's bytes of byte row r are at w0 + 128 r for r = 2 tq (mod
// 8), at w1 + 128 r for r = 2 tq + 1 (the swizzle moves them by row).
// 'block': each value times its column's scale, rounded to bf16.
template <int TM, int H, bool kBlock>
__device__ __forceinline__ void convert_slabs(const uint8_t* w0,
                                              const uint8_t* w1, int s0,
                                              int tq, const float* sc,
                                              uint32_t (&f)[4][TM][4]) {
  constexpr uint32_t kBits = H ? 0x4308u : 0x4300u;
  constexpr int kShift = H ? 4 : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (s0 + j) * 16 + 2 * tq;
    const uint32_t b0 = row_bytes<TM>(w0 + r * 128);
    const uint32_t b1 = row_bytes<TM>(w1 + (r + 1) * 128);
    const uint32_t b8 = row_bytes<TM>(w0 + (r + 8) * 128);
    const uint32_t b9 = row_bytes<TM>(w1 + (r + 9) * 128);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      // bytes: column 2 i, 2 i + 1 of the first row, then of the second
      constexpr uint32_t kSel0 = 0x5410u;
      const uint32_t sel = kSel0 + 0x2222u * i;
      const uint32_t v01 = __byte_perm(b0, b1, sel);
      const uint32_t v89 = __byte_perm(b8, b9, sel);
      uint32_t* a = f[j][i];
      a[0] = nibbles_to_bf16(v01 >> kShift, kBits);
      a[1] = nibbles_to_bf16(v01 >> (kShift + 8), kBits);
      a[2] = nibbles_to_bf16(v89 >> kShift, kBits);
      a[3] = nibbles_to_bf16(v89 >> (kShift + 8), kBits);
      if (kBlock) {
        a[0] = scale_pair(a[0], sc[2 * i]);
        a[1] = scale_pair(a[1], sc[2 * i + 1]);
        a[2] = scale_pair(a[2], sc[2 * i]);
        a[3] = scale_pair(a[3], sc[2 * i + 1]);
      }
    }
  }
}

// The products of four slabs (s0 / 16 ..) against x's slice `xs` (two
// atoms): d += A B, or d = A B by the first of slab 0
template <int NI, int TM>
__device__ __forceinline__ void issue_slabs(float (&d)[TM][NI / 2],
                                            uint32_t (&f)[4][TM][4],
                                            const uint8_t* xs, int s0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = s0 + j;
    const uint64_t db = evo_sm90::sw128_desc(
        xs + (s / 4) * MmaLayout<NI>::kAtom + (s % 4) * 32, 16, 1024);
#pragma unroll
    for (int i = 0; i < TM; ++i)
      evo_sm90::WgmmaRsK<NI>::run(d[i], f[j][i], db, s > 0);
  }
}

// Block b of G takes the units [b U / G, (b + 1) U / G) of the U = tiles x
// T units (column tile, step), tile by tile: a run of a tile's steps is a
// segment. A segment that is the whole tile writes y; else it writes its
// part, and the tile's last contributor in block order (`unit_block`)
// adds the parts in that order at the end of its range. No float atomics:
// a run is bit-reproducible. Warpgroup 0 is the producer
// (40 registers a thread): one thread fills the ring by TMA, a step's
// byte rows, scales and x's slices counted in bytes on the stage's `full`
// barrier (zeros past N, K and M). A weight whose rows TMA cannot take
// (N % 16, misaligned) is copied by all its threads instead. Warpgroups 1
// and 2 are the consumers (232 registers), TM tiles each; each consumer
// warp releases a stage on `empty` once the products that read it are
// done. Per step and nibble (chain), in two halves of four slabs: the
// fragments of a half are made in registers from the packed bytes while
// the products before them run; a chain's group sum is added, acc += dot
// * scale (float32; 'block': acc += dot, the scales being in the weights),
// when the next chain starts.
template <int NI, bool kBlock>
__global__ void __launch_bounds__(kMmaThreads, 1)
    int4_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap,
                    const int8_t* __restrict__ packed,
                    const float* __restrict__ scales, void* __restrict__ y,
                    float* __restrict__ part, int* __restrict__ counters,
                    int M, int Kp, int N, int tma_w, int out_bf16) {
  using Lay = MmaLayout<NI>;
  constexpr int TM = Lay::kTM, S = Lay::kStages, BN = Lay::kBN;
  extern __shared__ uint8_t msm_raw[];
  // the swizzle atoms need 1024-byte alignment
  uint8_t* const ring =
      msm_raw + ((1024 - (evo_sm90::smem_u32(msm_raw) & 1023)) & 1023);
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
      evo_sm90::mbar_init(&empty[s], kMmaConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kMmaProducers) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tma_w && tid) return;
    int q = 0;  // position in the ring
    for (int u = u_begin; u < u_end;) {
      const int n0 = u / T * BN;
      const int t0 = u % T, t1 = min(T, t0 + u_end - u);
      u += t1 - t0;
      for (int t = t0; t < t1; ++t, ++q) {
        const int s = q % S;
        if (q >= S) evo_sm90::mbar_wait(&empty[s], ((q / S) & 1) ^ 1);
        uint8_t* const st = ring + s * Lay::kStageBytes;
        uint8_t* const wd = st + Lay::kXBytes;
        float* const sd = reinterpret_cast<float*>(st + Lay::kScales);
        if (!tma_w) {
          // byte rows 128 t.. in the swizzled boxes, and the scales of
          // groups t and T + t (zeros past N), by every producer thread
          evo_int4::copy_step<kMmaProducers>(wd, sd, packed, scales, t, T,
                                             N, n0, BN, tid);
          if (tid) continue;
        }
        evo_sm90::mbar_expect_tx(
            &full[s], Lay::kXBytes +
                          (tma_w ? Lay::kWBytes + 2 * BN * 4 : 0));
        if (tma_w) {
#pragma unroll
          for (int b = 0; b < BN / 128; ++b)
            evo_sm90::tma_load_2d(wd + b * Lay::kBox, &wmap, &full[s],
                                  n0 + 128 * b, t * kBK);
          evo_sm90::tma_load_2d(sd, &smap, &full[s], n0, t);
          evo_sm90::tma_load_2d(sd + BN, &smap, &full[s], n0, T + t);
        }
        // x's slices: columns h Kp/2 + 128 t.., all rows
#pragma unroll
        for (int a = 0; a < 4; ++a)
          evo_sm90::tma_load_2d(st + a * Lay::kAtom, &xmap, &full[s],
                                (a >> 1) * (Kp / 2) + t * kBK + (a & 1) * 64,
                                0);
      }
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ctid = tid - kMmaProducers;
  const int wg = ctid >> 7, wi = (ctid >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's 2 TM columns of the block: byte 2 i + h is tile i's
  // fragment row g + 8 h; where they lie in a stage's boxes of byte rows
  const int cb = wg * TM * 64 + wi * 16 * TM + g * 2 * TM;
  const int wbox = (cb >> 7) * Lay::kBox + (cb & 15);
  const int wo0 = wbox + ((((cb & 127) >> 4) ^ (2 * tq)) << 4);
  const int wo1 = wbox + ((((cb & 127) >> 4) ^ (2 * tq + 1)) << 4);
  const bool vec_out = N % (2 * TM) == 0;
  float acc[TM][NI / 2], dot[TM][NI / 2];
  uint32_t fa[4][TM][4], fb[4][TM][4];
  float pend[2 * TM];  // the scales of dot's chain
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) dot[i][j] = 0.f;
#pragma unroll
  for (int e = 0; e < 2 * TM; ++e) pend[e] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[j][i][e] = fb[j][i][e] = 0u;

  // dot's chain done: acc += dot * its scales (rows g, g + 8: columns
  // 2 i, 2 i + 1); 'block': acc += dot
  auto add_dot = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        acc[i][j] = kBlock ? __fadd_rn(acc[i][j], dot[i][j])
                           : fmaf(dot[i][j], pend[2 * i + ((j >> 1) & 1)],
                                  acc[i][j]);
  };
  // every thread of the warp is done with stage s
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) evo_sm90::mbar_arrive(&empty[s]);
  };

  int q = 0;
  // tiles whose parts this block adds. Only a block's first segment can
  // end a tile that it did not begin, so held1 stays -1; a build with one
  // slot ran slower at 8 and 32 rows all the same (PERF.md, PR 20)
  int held0 = -1, held1 = -1;
  for (int u = u_begin; u < u_end;) {
    const int tile = u / T, n0 = tile * BN, n = n0 + cb;
    const int t0 = u % T, t1 = min(T, t0 + u_end - u);
    u += t1 - t0;
    // contributors to the tile: blocks b0 .. b1; this one is k = b - b0
    const bool whole = t0 == 0 && t1 == T;
    const int b0 = unit_block(tile * T, U, G);
    const int b1 = unit_block(tile * T + T - 1, U, G);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) acc[i][j] = 0.f;
    for (int t = t0; t < t1; ++t, ++q) {
      const int s = q % S, prev = (q + S - 1) % S;
      evo_sm90::mbar_wait(&full[s], (q / S) & 1);
      const uint8_t* const st = ring + s * Lay::kStageBytes;
      const uint8_t* const w0 = st + Lay::kXBytes + wo0;
      const uint8_t* const w1 = st + Lay::kXBytes + wo1;
      // low nibbles belong to scale group t, high ones to group T + t
      float sc[2][2 * TM];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2 * TM; ++e)
          sc[h][e] = reinterpret_cast<const float*>(
              st + Lay::kScales)[h * BN + cb + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* const xs = st + 2 * h * Lay::kAtom;
        // everything but the previous chain's second half is done: fa is
        // free
        evo_sm90::wgmma_wait<1>();
        fence_frags(fa);
        if (h == 0)
          convert_slabs<TM, 0, kBlock>(w0, w1, 0, tq, sc[0], fa);
        else
          convert_slabs<TM, 1, kBlock>(w0, w1, 0, tq, sc[1], fa);
        // the previous chain is done: add its sum, then reuse dot
        evo_sm90::wgmma_wait<0>();
        fence_frags(fb);
        fence_tiles(dot);
        if (h == 1 || t > t0) add_dot();
#pragma unroll
        for (int e = 0; e < 2 * TM; ++e) pend[e] = sc[h][e];
        if (h == 0 && t > t0) release(prev);
        evo_sm90::wgmma_fence();
        issue_slabs<NI, TM>(dot, fa, xs, 0);
        evo_sm90::wgmma_commit();
        if (h == 0)
          convert_slabs<TM, 0, kBlock>(w0, w1, 4, tq, sc[0], fb);
        else
          convert_slabs<TM, 1, kBlock>(w0, w1, 4, tq, sc[1], fb);
        evo_sm90::wgmma_fence();
        issue_slabs<NI, TM>(dot, fb, xs, 4);
        evo_sm90::wgmma_commit();
      }
      if (t + 1 == t1) {
        // the segment's last step: its last chain's sum, and its stage
        evo_sm90::wgmma_wait<0>();
        fence_frags(fa);
        fence_frags(fb);
        fence_tiles(dot);
        add_dot();
        release(s);
      }
    }

    // y, or this block's part: element j of tile i is row 8 (j / 4) +
    // 2 tq + (j & 1) of x, column 2 i + (j / 2) % 2 of the thread's
    float* const dst = part + (int64_t)(blockIdx.x - b0) * M * N;
#pragma unroll
    for (int jj = 0; jj < NI / 8; ++jj)
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        const int m = 8 * jj + 2 * tq + lo;
        if (m < M && n < N) {
          float v[2 * TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              v[2 * i + hh] = acc[i][4 * jj + 2 * hh + lo];
          if (whole)
            store_cols<TM>(y, out_bf16 != 0, (int64_t)m * N + n, v, N - n,
                           vec_out);
          else
            store_cols<TM>(dst, false, (int64_t)m * N + n, v, N - n,
                           vec_out);
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
  // them cannot stall them), their sum in block order is y
  for (int r = 0; r < 2; ++r) {
    const int tile = r ? held1 : held0;
    if (tile < 0) continue;
    const int b0 = unit_block(tile * T, U, G);
    const int parts = blockIdx.x - b0 + 1;
    if (ctid == 0) {
      const int want = (parts - 1) * (kMmaConsumers / 32);
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
    asm volatile("bar.sync 1, %0;\n" ::"n"(kMmaConsumers) : "memory");
    if (N % 4 == 0)
      evo_int4::combine_parts<4>(part, y, out_bf16 != 0, M, N, tile * BN, BN,
                                 parts, nullptr, ctid);
    else
      evo_int4::combine_parts<1>(part, y, out_bf16 != 0, M, N, tile * BN, BN,
                                 parts, nullptr, ctid);
  }
}

template <int NI, bool kBlock>
int launch_mma(const void* x, const void* packed, const void* scales,
               void* y, void* part, void* counters, int M, int K, int Kp,
               int N, int blocks, int out_bf16, void* stream) {
  using Lay = MmaLayout<NI>;
  const int U = (N + Lay::kBN - 1) / Lay::kBN * (Kp / 256);
  if (K % 8 || (uintptr_t)x % 16 || blocks < 1 || blocks > U || M > NI)
    return (int)cudaErrorInvalidValue;
  // a tile is split unless every block's units are whole tiles
  if (U % blocks || (U / blocks) % (Kp / 256)) {
    if (part == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  // x's slices as 64-column atoms of NI rows (zeros past K and M)
  CUtensorMap xm, wm, sm;
  CUresult r = evo_int4::cached_map(&xm, x, M, K,
                                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64,
                                    NI, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return evo_sm90::kEncodeError + (int)r;
  // byte rows in 128 x 128 boxes, the scales a row of kBN: TMA takes
  // 16-byte aligned rows
  int tma_w = 0;
  r = evo_int4::weight_maps(&wm, &sm, packed, scales, Kp, N, Lay::kBN,
                            &tma_w);
  if (r != CUDA_SUCCESS) return evo_sm90::kEncodeError + (int)r;
  auto kernel = int4_mma_kernel<NI, kBlock>;
  static uint64_t configured = 0;  // a bit a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(configured >> (dev & 63) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << (dev & 63);
  }
  kernel<<<blocks, kMmaThreads, Lay::kSmem, (cudaStream_t)stream>>>(
      xm, wm, sm, (const int8_t*)packed, (const float*)scales, y,
      (float*)part, (int*)counters, M, Kp, N, tma_w, out_bf16);
  return (int)cudaGetLastError();
}

// The instance of the design that M and `gemv` pick
template <bool kBlock>
int dispatch(const void* x, const void* packed, const void* scales, void* y,
             void* part, void* counters, int M, int K, int Kp, int N,
             int out_bf16, int gemv, int blocks, void* stream) {
  if (gemv) {
    if (M <= 1)
      return launch_gemv<1, kBlock>(x, packed, scales, y, part, counters, M,
                                    K, Kp, N, out_bf16, stream);
    return launch_gemv<2, kBlock>(x, packed, scales, y, part, counters, M, K,
                                  Kp, N, out_bf16, stream);
  }
  if (M <= 16)
    return launch_mma<16, kBlock>(x, packed, scales, y, part, counters, M, K,
                                  Kp, N, blocks, out_bf16, stream);
  if (M <= 32)
    return launch_mma<32, kBlock>(x, packed, scales, y, part, counters, M, K,
                                  Kp, N, blocks, out_bf16, stream);
  if (M <= 64)
    return launch_mma<64, kBlock>(x, packed, scales, y, part, counters, M, K,
                                  Kp, N, blocks, out_bf16, stream);
  return launch_mma<128, kBlock>(x, packed, scales, y, part, counters, M, K,
                                 Kp, N, blocks, out_bf16, stream);
}

}  // namespace

// x: (M, K) bf16, contiguous, 1 <= M <= 128, K <= Kp, Kp a multiple of
// 256 (for the wgmma design also K % 8 == 0 and x 16-byte aligned);
// packed: (Kp/2, N) int8, contiguous; scales: (Kp/128, N) fp32,
// contiguous; y: (M, N) fp32, or bf16 when out_bf16, contiguous. `gemv`
// (M <= 2) picks the streaming design, whose blocks take one step of 128
// byte rows each (Kp / 256 splits); else the wgmma design on `blocks`
// blocks (`ops/int4.mma_plan`). With more than one split or contributor
// to a tile, `part` holds that many x M x N fp32 and `counters` one zeroed
// int32 a column tile (512 columns, or the wgmma instance's), which the
// kernel leaves zeroed. `block` picks the 'block' mode's instance.
extern "C" int evo_int4_matmul_bf16(const void* x, const void* packed,
                                    const void* scales, void* y, void* part,
                                    void* counters, int M, int K, int Kp,
                                    int N, int out_bf16, int gemv, int block,
                                    int blocks, void* stream) {
  if (K > Kp || Kp % 256 || M < 1 || M > 128 || (gemv && M > 2))
    return (int)cudaErrorInvalidValue;
  return block ? dispatch<true>(x, packed, scales, y, part, counters, M, K,
                                Kp, N, out_bf16, gemv, blocks, stream)
               : dispatch<false>(x, packed, scales, y, part, counters, M, K,
                                 Kp, N, out_bf16, gemv, blocks, stream);
}
