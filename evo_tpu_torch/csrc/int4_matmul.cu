// Weight-only int4 matmul with group-128 scales, for up to 128 activation
// rows:
//
//   y[m, n] = sum_g scales[g, n] *
//             ( x[m, 128g:128(g+1)] . unpack(packed)[128g:128(g+1), n] )
//
// x (M, Kp) bf16, packed (Kp/2, N) int8, scales (Kp/128, N) fp32, y (M, N)
// fp32; Kp is a multiple of 256. Byte row j of `packed` holds natural row j
// in its low nibble, stored as value + 8, and natural row Kp/2 + j in its
// high nibble in two's complement (the `pack_int4` layout, in which weights
// cross between the two packages).
//
// Replaces: evo_tpu/ops/pallas_int4.py `_int4_kernel` in its default mode
// ('unroll'), called through `int4_matmul`. One launch per quantized
// projection of a decode step: five a layer, 160 a step of evo-1.
//
// Bound on the card: bytes. A decode step (M = batch) reads every packed
// weight once, half a byte per weight plus 4 bytes of scale per 128 of
// them, and computes 2 * M operations per weight: far below the 295
// operations per byte at which the tensor cores would be the limit.
//
// Design: a block of 4 warps owns 32 output columns for all M rows and
// walks the byte rows in steps of 128. Step t carries the low nibbles of
// scale group t (activation columns 128t..) and the high nibbles of group
// G/2 + t (activation columns Kp/2 + 128t..). What a step reads from
// device memory, the 32 bytes of each of its 128 byte rows (one 32-byte
// sector along N) and the two 128-column slices of x (x as a whole does
// not fit: 2.8 MB at M = 128, Kp = 11008), arrives by cp.async in a ring
// of two to four stages in shared memory, so that several steps are in
// flight while one is worked on. A thread unpacks two byte rows of 16 columns of the
// stage that has landed, both nibbles to bf16 by bit operations (no
// integer-to-float conversion), and writes them transposed, [column][k],
// so that the pairs along k that an mma.sync B fragment wants are one
// 32-bit word. Each warp then owns 8 columns: per group 8 mma.sync
// m16n8k16 steps per 16-row tile of x into a partial sum, and at the
// group's end acc += partial * scale, in fp32, the multiply and the add
// rounded apart as the plain version does. M is padded to 16-row tiles
// with zeros in shared memory only (1, 2, 4 or 8 tiles, a template
// parameter, so the accumulators stay in registers). N need not be a
// multiple of 32: bytes past N are not read and columns past N not
// stored; rows that 16-byte copies cannot take (N not a multiple of 16)
// are loaded byte by byte. With N = 4096 there are 128 blocks for 132 SMs;
// splitting K across blocks is left to a later version.

#include <cstdint>

#include "common.cuh"

namespace {

using evo::cp_async16;
using evo::cp_async_commit;
using evo::cp_async_wait;
using evo::mma_bf16_16816;

constexpr int kBN = 32;        // output columns per block
constexpr int kBK = 128;       // byte rows per block step = scale group
constexpr int kThreads = 128;  // one thread per byte row of a step
constexpr int kStride = kBK + 8;  // smem row stride: conflict-free reads

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

template <int MT>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ packed,
                       const float* __restrict__ scales,
                       float* __restrict__ y, int M, int Kp, int N,
                       int vec) {
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

  // start the copies of step t into its stage
  auto fetch = [&](int t) {
    const int stage = t % kStages;
    fetch_row(wp + ((int64_t)t * kBK + tid) * N, valid, vec != 0,
              Raw + (stage * kBK + tid) * kBN);
    __nv_bfloat16* xs = Xs + stage * 2 * kXRows * kStride;
    for (int i = tid; i < 2 * M * (kBK / 8); i += kThreads) {
      const int half = i / (M * (kBK / 8));
      const int rem = i % (M * (kBK / 8));
      const int row = rem / (kBK / 8), ch = rem % (kBK / 8);
      cp_async16(xs + (half * kXRows + row) * kStride + ch * 8,
                 x + (int64_t)row * Kp + (half ? Kp / 2 : 0) + t * kBK +
                     ch * 8);
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
    // that each column's pair along k is one 32-bit store
    {
      const int rp = tid & 63, ch = tid >> 6;
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
        *reinterpret_cast<uint32_t*>(Wlo + at) = nibbles_to_bf16(v, 0x4300);
        *reinterpret_cast<uint32_t*>(Whi + at) =
            nibbles_to_bf16(v >> 4, 0x4308);
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
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][e] = __fadd_rn(acc[mt][e],
                                 __fmul_rn(part[mt][e], sc[half][e & 1]));
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mt * 16 + g + ((e & 2) ? 8 : 0);
      const int c = col + (e & 1);
      if (row < M && c < N) y[(int64_t)row * N + c] = acc[mt][e];
    }
}

template <int MT>
int launch(const void* x, const void* packed, const void* scales, void* y,
           int M, int Kp, int N, int vec, void* stream) {
  const int bytes = (2 * kBN + stages_for(MT) * 2 * MT * 16) * kStride *
                        (int)sizeof(__nv_bfloat16) +
                    stages_for(MT) * kBK * kBN;
  auto kernel = int4_matmul_kernel<MT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(N + kBN - 1) / kBN, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)packed, (const float*)scales,
      (float*)y, M, Kp, N, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, Kp) bf16, contiguous, 16-byte aligned, 1 <= M <= 128, Kp a
// multiple of 256; packed: (Kp/2, N) int8, contiguous; scales: (Kp/128, N)
// fp32, contiguous; y: (M, N) fp32, contiguous.
extern "C" int evo_int4_matmul_bf16(const void* x, const void* packed,
                                    const void* scales, void* y, int M,
                                    int Kp, int N, void* stream) {
  const int vec = (N % 16 == 0) && ((uintptr_t)packed % 16 == 0);
  const int tiles = (M + 15) / 16;
  if (tiles <= 1)
    return launch<1>(x, packed, scales, y, M, Kp, N, vec, stream);
  if (tiles <= 2)
    return launch<2>(x, packed, scales, y, M, Kp, N, vec, stream);
  if (tiles <= 4)
    return launch<4>(x, packed, scales, y, M, Kp, N, vec, stream);
  return launch<8>(x, packed, scales, y, M, Kp, N, vec, stream);
}
