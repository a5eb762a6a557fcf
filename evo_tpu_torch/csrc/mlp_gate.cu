// Front half of the gated MLP in one kernel: out = act(x @ w1) * (x @ w2),
// bf16 in and out, both products summed in float32 and rounded once, at
// the store. The (M, I) intermediates x @ w1 and x @ w2 never reach device
// memory.
//
// Replaces: evo_tpu/ops/pallas_mlp.py `_kernel` (called through
// `fused_gate_pallas`). No model path of either package calls it (the
// layers keep two projections and a gate); its callers are the tests and
// the smoke run.
//
// Bound on the card: operations at many rows (M = 8192, D = 4096,
// I = 10928: 1.47 TFLOP, 1.48 ms at 989 TFLOP/s bf16, against 425 MB or
// 0.13 ms of bytes), bytes at few (M = 2: the two weights, 179 MB,
// 0.053 ms).
//
// Design (sm_90a; the building blocks of `sm90.cuh`): a block owns BM rows
// by BN columns of the output, for both weights at once, so every x tile
// feeds two products. Warpgroup 0 is the producer: one thread issues the
// TMA loads of a ring of kStages stages, each an x tile of BM x 64 (K-major
// A operand) and w1, w2 tiles of 64 x BN, row-major (D, I) as they lie, so
// the MN-major B operand with the transpose bit (the layout of V in the
// attention mainloop); all under the 128-byte swizzle, with full and free
// mbarriers. Each consumer warpgroup takes 64 rows and runs wgmma
// m64nBNk16 into two fp32 accumulators, one per weight, keeping one stage's
// products in flight while the next is issued. The epilogue applies the
// activation (erff for the exact GELU) and the gate in registers and
// rounds once.
//   - Many rows (M > 64): BM = 128 (two consumer warpgroups, 128
//     accumulator registers each), BN = 128, four stages of 48 KB; blocks
//     are ordered in groups of 16 row tiles, so the x tiles of a group stay
//     in L2 while the weights stream past them once a group.
//   - Few rows (M <= 64): BM = 64 (one consumer warpgroup) and BN = 64,
//     so I = 10928 gives 171 blocks, two an SM (four stages of 24 KB), to
//     stream the weights: no row tile is wider than one wgmma's 64 rows.
// TMA needs 16-byte strides and bases: the wrapper pads D and I to
// multiples of 8 with zeros (and copies a misaligned operand), as the JAX
// wrapper pads, and slices the padding off the output. Rows past M load as
// zeros and are not stored.

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using evo::pack_bf16;
using namespace evo_sm90;

constexpr int kBK = 64;          // contraction a stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kGroupRows = 16;   // row tiles a rasterisation group

enum Act { kGelu = 0, kGeluTanh = 1, kSilu = 2, kRelu = 3, kIdentity = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu:
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    case kGeluTanh:
      return 0.5f * v *
             (1.f + tanhf(0.79788456080286536f *
                          (v + 0.044715f * v * v * v)));
    case kSilu:
      return v / (1.f + expf(-v));
    case kRelu:
      return fmaxf(v, 0.f);
    default:
      return v;
  }
}

template <int kWG, int kBN>
struct Tile {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * (1 + kWG);
  static constexpr int kXBytes = kBM * 128;        // one atom of kBM rows
  static constexpr int kWAtom = kBK * 128;         // 64 rows x 128 bytes
  static constexpr int kWBytes = (kBN / 64) * kWAtom;
  static constexpr int kStageBytes = kXBytes + 2 * kWBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 128;
  static constexpr int kAcc = kBN / 2;             // fp32 a thread, a product
};

// d (+)= A (64 x 16 of x) B (16 x kBN of a weight, MN-major)
template <int kBN>
__device__ __forceinline__ void gate_mma(float (&d)[kBN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (kBN == 128)
    wgmma_ss<1>(d, da, db, accumulate);
  else
    wgmma_ss_n64_tb(d, da, db, accumulate);
}

// x: 2-d map over (M, D), boxes of 64 columns x kBM rows; w1, w2: 2-d maps
// over (D, I), boxes of 64 x 64; out: (M, I) bf16 contiguous, I % 8 == 0.
template <int kWG, int kBN>
__global__ void __launch_bounds__(Tile<kWG, kBN>::kThreads, 3 - kWG)
    mlp_gate_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap w2map,
                    __nv_bfloat16* __restrict__ out, int M, int D, int I,
                    int act) {
  using Tl = Tile<kWG, kBN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(ring + kStages * Tl::kStageBytes);
  uint64_t* const empty = full + kStages;

  // grouped rasterisation: kGroupRows row tiles walk the column tiles
  const int n_m = (M + Tl::kBM - 1) / Tl::kBM;
  const int n_n = (I + kBN - 1) / kBN;
  const int per_group = kGroupRows * n_n;
  const int first_m = ((int)blockIdx.x / per_group) * kGroupRows;
  const int rows_here = min(kGroupRows, n_m - first_m);
  const int local = (int)blockIdx.x % per_group;
  const int m0 = (first_m + local % rows_here) * Tl::kBM;
  const int n0 = (local / rows_here) * kBN;
  const int nk = (D + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (kWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        uint8_t* const st = ring + s * Tl::kStageBytes;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], Tl::kStageBytes);
        tma_load_2d(st, &xmap, &full[s], kt * kBK, m0);
#pragma unroll
        for (int a = 0; a < kBN / 64; ++a) {
          tma_load_2d(st + Tl::kXBytes + a * Tl::kWAtom, &w1map, &full[s],
                      n0 + 64 * a, kt * kBK);
          tma_load_2d(st + Tl::kXBytes + Tl::kWBytes + a * Tl::kWAtom,
                      &w2map, &full[s], n0 + 64 * a, kt * kBK);
        }
      }
    }
  } else {
    if constexpr (kWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    float a1[Tl::kAcc], a2[Tl::kAcc];
#pragma unroll
    for (int i = 0; i < Tl::kAcc; ++i) a1[i] = a2[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const uint8_t* const st = ring + s * Tl::kStageBytes;
      mbar_wait(&full[s], (kt / kStages) & 1);
      fence_regs(a1);
      fence_regs(a2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = sw128_desc(st + c * 64 * 128 + 32 * kk, 16, 1024);
        const int acc = kt > 0 || kk > 0;
        gate_mma<kBN>(a1, da,
                      sw128_desc(st + Tl::kXBytes + 2048 * kk, Tl::kWAtom,
                                 1024),
                      acc);
        gate_mma<kBN>(a2, da,
                      sw128_desc(st + Tl::kXBytes + Tl::kWBytes + 2048 * kk,
                                 Tl::kWAtom, 1024),
                      acc);
      }
      wgmma_commit();
      // the products of stage kt - 1 are done: free it
      wgmma_wait<1>();
      fence_regs(a1);
      fence_regs(a2);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(a1);
    fence_regs(a2);

    // a1[4 j + e] holds row 16 warp + g + 8 (e >> 1), column 8 j + 2 tq +
    // (e & 1) of this warpgroup's 64 x kBN tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + 16 * warp + g + 8 * h;
      if (row >= M) continue;
      __nv_bfloat16* const orow = out + (int64_t)row * I;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col < I)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
              activate(a1[4 * j + 2 * h], act) * a2[4 * j + 2 * h],
              activate(a1[4 * j + 2 * h + 1], act) * a2[4 * j + 2 * h + 1]);
      }
    }
  }
}

// a 2-d bf16 map over a row-major (rows, cols) matrix, boxes of 64 columns
// x box_rows rows under the 128-byte swizzle
CUresult encode_2d(CUtensorMap* map, const void* base, int rows, int cols,
                   int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int kWG, int kBN>
int launch(const void* x, const void* w1, const void* w2, void* out, int M,
           int D, int I, int act, cudaStream_t stream) {
  using Tl = Tile<kWG, kBN>;
  CUtensorMap xm, w1m, w2m;
  CUresult r = encode_2d(&xm, x, M, D, Tl::kBM);
  if (r == CUDA_SUCCESS) r = encode_2d(&w1m, w1, D, I, kBK);
  if (r == CUDA_SUCCESS) r = encode_2d(&w2m, w2, D, I, kBK);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      mlp_gate_kernel<kWG, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_m = (M + Tl::kBM - 1) / Tl::kBM;
  const int n_n = (I + kBN - 1) / kBN;
  mlp_gate_kernel<kWG, kBN><<<n_m * n_n, Tl::kThreads, Tl::kSmem, stream>>>(
      xm, w1m, w2m, (__nv_bfloat16*)out, M, D, I, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, D), w1, w2: (D, I), out: (M, I); all bf16, contiguous, 16-byte
// aligned, D and I multiples of 8. act: 0 gelu (erf), 1 gelu_tanh, 2 silu,
// 3 relu, 4 identity.
extern "C" int evo_mlp_gate_bf16(const void* x, const void* w1,
                                 const void* w2, void* out, int M, int D,
                                 int I, int act, void* stream) {
  if (D % 8 || I % 8) return (int)cudaErrorInvalidValue;
  if (M <= 64)
    return launch<1, 64>(x, w1, w2, out, M, D, I, act, (cudaStream_t)stream);
  return launch<2, 128>(x, w1, w2, out, M, D, I, act, (cudaStream_t)stream);
}
