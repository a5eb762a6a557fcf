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
// Bound on the card: bytes. A decode step (M = batch) reads every packed
// weight once, half a byte per weight plus 4 bytes of scale per 128 of
// them, and computes 2 * M operations per weight: far below the 295
// operations per byte at which the tensor cores would be the limit.
//
// Two designs, chosen by the caller by M:
//
// M <= 4 (decode; `int4_gemv_kernel`): a streaming design, no tensor
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
// clusters' placement cost more than the ticket's round trips.)
//
// 'block' costs a multiply and a rounding to bf16 a weight more in both
// designs (the streaming one in registers, the mma.sync one as it unpacks
// into shared memory), and drops the scale from each group's sum.
//
// M = 5..128 (`int4_matmul_kernel`): a block of 4 warps owns 32 output
// columns for all M rows and walks the byte rows in steps of 128. What a
// step reads, the 32 bytes of each of its 128 byte rows and the two
// 128-column slices of x, arrives by cp.async in a ring of two to four
// stages. A thread unpacks two byte rows of 16 columns, both nibbles to
// bf16 by bit operations, and writes them transposed, [column][k], so
// that the pairs along k that an mma.sync B fragment wants are one 32-bit
// word. Each warp then owns 8 columns: per group 8 mma.sync m16n8k16
// steps per 16-row tile of x into a partial sum, and at the group's end
// acc += partial * scale. M is padded to 16-row tiles with zeros in shared
// memory only. This path needs K % 8 == 0 and a 16-byte aligned x.

#include <cstdint>

#include "common.cuh"

namespace {

using evo::cp_async16;
using evo::cp_async16_zfill;
using evo::cp_async_commit;
using evo::cp_async_wait;
using evo::mma_bf16_16816;

constexpr int kBN = 32;        // output columns per block
constexpr int kBK = 128;       // byte rows per block step = scale group
constexpr int kThreads = 128;  // one thread per byte row of a step
constexpr int kStride = kBK + 8;  // smem row stride: conflict-free reads

__device__ __forceinline__ void store_y(void* y, bool out_bf16, int64_t i,
                                        float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[i] = v;
}

// ---- M <= 4 -------------------------------------------------------------

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

// ---- M = 5..128 ---------------------------------------------------------

// Stages of the ring by row tiles: what is in flight has to cover the
// memory's latency (about 20 KB an SM at full rate), and a stage holds
// 4 KB of packed bytes; the slices of x bound the count from above.
__host__ __device__ constexpr int stages_for(int mt) {
  return mt <= 2 ? 4 : (mt <= 4 ? 3 : 2);
}

// The 32 bytes of one byte row from column n0 on into `dst` (shared
// memory); `valid` of them exist. 16-byte copies where the row allows
// them, else bytes, with zeros past the row's end.
__device__ __forceinline__ void fetch_row(const int8_t* __restrict__ p,
                                          int valid, bool vec,
                                          uint8_t* dst) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (vec && valid >= 16 * (c + 1)) {
      cp_async16(dst + 16 * c, p + 16 * c);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 16 * c + i;
        if (col < valid)
          w[i >> 2] |= (uint32_t)(uint8_t)p[col] << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(dst + 16 * c) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The nibbles in bits 0-3 and 16-19 of v as two bf16 values, without a
// conversion: 0x4300 | n is bf16(128 + n), and subtracting bf16(136) in
// bf16 is exact. `bits` 0x4300 takes a nibble stored as value + 8 (the low
// one); 0x4308 also flips bit 3, which turns a two's-complement nibble
// (the high one) into value + 8 first.
__device__ __forceinline__ uint32_t nibbles_to_bf16(uint32_t v,
                                                    uint32_t bits) {
  const uint32_t biased = (v & 0x000f000fu) ^ (bits | (bits << 16));
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

template <int MT, bool kBlock>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ packed,
                       const float* __restrict__ scales,
                       void* __restrict__ y, int M, int K, int Kp, int N,
                       int vec, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kXRows = MT * 16;
  constexpr int kStages = stages_for(MT);
  __nv_bfloat16* Wlo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Whi = Wlo + kBN * kStride;
  // the ring: stage s holds x slices Xs + s * 2 * kXRows * kStride (low
  // half, then high half) and byte rows Raw + s * kBK * kBN
  __nv_bfloat16* Xs = Whi + kBN * kStride;
  uint8_t* Raw =
      reinterpret_cast<uint8_t*>(Xs + kStages * 2 * kXRows * kStride);

  const int n0 = blockIdx.x * kBN;
  const int valid = min(kBN, N - n0);
  const int T = Kp / 256;  // steps; scale groups G = 2 T
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int col = n0 + warp * 8 + tq * 2;  // this thread's columns: col, +1
  const int8_t* wp = packed + n0;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  // rows of x past M stay zeros in every stage
  for (int i = tid; i < kStages * 2 * kXRows * (kBK / 8); i += kThreads) {
    const int row = (i / (kBK / 8)) % kXRows;
    if (row >= M)
      *reinterpret_cast<uint4*>(Xs + (i / (kBK / 8)) * kStride +
                                (i % (kBK / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // start the copies of step t into its stage; columns of x at K and past
  // it (K % 8 == 0, so a 16-byte chunk lies wholly on one side) arrive as
  // zeros
  auto fetch = [&](int t) {
    const int stage = t % kStages;
    fetch_row(wp + ((int64_t)t * kBK + tid) * N, valid, vec != 0,
              Raw + (stage * kBK + tid) * kBN);
    __nv_bfloat16* xs = Xs + stage * 2 * kXRows * kStride;
    for (int i = tid; i < 2 * M * (kBK / 8); i += kThreads) {
      const int half = i / (M * (kBK / 8));
      const int rem = i % (M * (kBK / 8));
      const int row = rem / (kBK / 8), ch = rem % (kBK / 8);
      const int k = (half ? Kp / 2 : 0) + t * kBK + ch * 8;
      cp_async16_zfill(xs + (half * kXRows + row) * kStride + ch * 8,
                       k < K ? x + (int64_t)row * K + k : x,
                       k < K ? 16 : 0);
    }
  };

  // one group of copies per step, empty past the last step, so that the
  // count of groups in flight says which step has landed
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < T) fetch(t);
    cp_async_commit();
  }

  for (int t = 0; t < T; ++t) {
    // step t has landed, and every warp is done with step t - 1, whose
    // stage the copies of step t + kStages - 1 now take
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < T) fetch(t + kStages - 1);
    cp_async_commit();
    const float* sp_lo = scales + (int64_t)t * N;
    const float* sp_hi = scales + (int64_t)(T + t) * N;
    const float sc[2][2] = {
        {col < N ? sp_lo[col] : 0.f, col + 1 < N ? sp_lo[col + 1] : 0.f},
        {col < N ? sp_hi[col] : 0.f, col + 1 < N ? sp_hi[col + 1] : 0.f}};

    // unpack: a thread takes two byte rows (k, k + 1) of 16 columns, so
    // that each column's pair along k is one 32-bit store; 'block' scales
    // each weight by its column's scale of the group and rounds it
    {
      const int rp = tid & 63, ch = tid >> 6;
      float slo[16], shi[16];
      if (kBlock) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int n = n0 + ch * 16 + c;
          slo[c] = n < N ? __ldg(sp_lo + n) : 0.f;
          shi[c] = n < N ? __ldg(sp_hi + n) : 0.f;
        }
      }
      const uint8_t* rows =
          Raw + ((t % kStages) * kBK + 2 * rp) * kBN + ch * 16;
      const uint4 ra = *reinterpret_cast<const uint4*>(rows);
      const uint4 rb = *reinterpret_cast<const uint4*>(rows + kBN);
      const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w};
      const uint32_t wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        // byte c of row k in bits 0-7, of row k + 1 in bits 16-23
        const uint32_t v =
            __byte_perm(wa[c >> 2], wb[c >> 2], 0x4400 + (c & 3) * 0x1111);
        const int at = (ch * 16 + c) * kStride + 2 * rp;
        uint32_t lo = nibbles_to_bf16(v, 0x4300);
        uint32_t hi = nibbles_to_bf16(v >> 4, 0x4308);
        if (kBlock) {
          lo = scale_pair(lo, slo[c]);
          hi = scale_pair(hi, shi[c]);
        }
        *reinterpret_cast<uint32_t*>(Wlo + at) = lo;
        *reinterpret_cast<uint32_t*>(Whi + at) = hi;
      }
    }
    __syncthreads();

    const __nv_bfloat16* xstage =
        Xs + (t % kStages) * 2 * kXRows * kStride;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat16* Ws = half ? Whi : Wlo;
      const __nv_bfloat16* xh = xstage + half * kXRows * kStride;
      float part[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int k = kk * 16 + tq * 2;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(
            Ws + (warp * 8 + g) * kStride + k);
        b[1] = *reinterpret_cast<const uint32_t*>(
            Ws + (warp * 8 + g) * kStride + k + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat16* xr = xh + (mt * 16 + g) * kStride + k;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(xr);
          a[1] = *reinterpret_cast<const uint32_t*>(xr + 8 * kStride);
          a[2] = *reinterpret_cast<const uint32_t*>(xr + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(xr + 8 * kStride + 8);
          mma_bf16_16816(part[mt], a, b);
        }
      }
      // low nibbles belong to scale group t, high ones to group T + t
      // ('block': the scales are in the weights)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][e] = __fadd_rn(
              acc[mt][e],
              kBlock ? part[mt][e] : __fmul_rn(part[mt][e], sc[half][e & 1]));
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mt * 16 + g + ((e & 2) ? 8 : 0);
      const int c = col + (e & 1);
      if (row < M && c < N)
        store_y(y, out_bf16 != 0, (int64_t)row * N + c, acc[mt][e]);
    }
}

template <int MT, bool kBlock>
int launch(const void* x, const void* packed, const void* scales, void* y,
           int M, int K, int Kp, int N, int out_bf16, void* stream) {
  if (K % 8 || (uintptr_t)x % 16) return (int)cudaErrorInvalidValue;
  const int vec = (N % 16 == 0) && ((uintptr_t)packed % 16 == 0);
  const int bytes = (2 * kBN + stages_for(MT) * 2 * MT * 16) * kStride *
                        (int)sizeof(__nv_bfloat16) +
                    stages_for(MT) * kBK * kBN;
  auto kernel = int4_matmul_kernel<MT, kBlock>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(N + kBN - 1) / kBN, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)packed, (const float*)scales,
      y, M, K, Kp, N, vec, out_bf16);
  return (int)cudaGetLastError();
}

// The instance of the design that M and `gemv` pick
template <bool kBlock>
int dispatch(const void* x, const void* packed, const void* scales, void* y,
             void* part, void* counters, int M, int K, int Kp, int N,
             int out_bf16, int gemv, void* stream) {
  if (gemv) {
    if (M <= 1)
      return launch_gemv<1, kBlock>(x, packed, scales, y, part, counters, M,
                                    K, Kp, N, out_bf16, stream);
    if (M <= 2)
      return launch_gemv<2, kBlock>(x, packed, scales, y, part, counters, M,
                                    K, Kp, N, out_bf16, stream);
    return launch_gemv<4, kBlock>(x, packed, scales, y, part, counters, M, K,
                                  Kp, N, out_bf16, stream);
  }
  const int tiles = (M + 15) / 16;
  if (tiles <= 1)
    return launch<1, kBlock>(x, packed, scales, y, M, K, Kp, N, out_bf16,
                             stream);
  if (tiles <= 2)
    return launch<2, kBlock>(x, packed, scales, y, M, K, Kp, N, out_bf16,
                             stream);
  if (tiles <= 4)
    return launch<4, kBlock>(x, packed, scales, y, M, K, Kp, N, out_bf16,
                             stream);
  return launch<8, kBlock>(x, packed, scales, y, M, K, Kp, N, out_bf16,
                           stream);
}

}  // namespace

// x: (M, K) bf16, contiguous, 1 <= M <= 128, K <= Kp, Kp a multiple of
// 256 (for the mma.sync design also K % 8 == 0 and x 16-byte aligned);
// packed: (Kp/2, N) int8, contiguous; scales: (Kp/128, N) fp32,
// contiguous; y: (M, N) fp32, or bf16 when out_bf16, contiguous. `gemv`
// (M <= 4) picks the streaming design, else the mma.sync one: there a
// block takes one step of 128 byte rows, so the contraction is split into
// Kp / 256 parts; with more than one, `part` holds parts x M x N fp32 and
// `counters` one zeroed int32 per 512 columns, which the kernel leaves
// zeroed. `block` picks the 'block' mode's instance.
extern "C" int evo_int4_matmul_bf16(const void* x, const void* packed,
                                    const void* scales, void* y, void* part,
                                    void* counters, int M, int K, int Kp,
                                    int N, int out_bf16, int gemv, int block,
                                    void* stream) {
  if (K > Kp || Kp % 256 || (gemv && M > 4))
    return (int)cudaErrorInvalidValue;
  return block ? dispatch<true>(x, packed, scales, y, part, counters, M, K,
                                Kp, N, out_bf16, gemv, stream)
               : dispatch<false>(x, packed, scales, y, part, counters, M, K,
                                 Kp, N, out_bf16, gemv, stream);
}
