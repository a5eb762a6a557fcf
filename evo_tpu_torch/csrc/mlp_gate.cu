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
// Design: a block of 8 warps owns 128 rows by 64 columns of the output,
// for both weights at once, so every x tile feeds two products. Tiles of
// 64 along the contraction arrive by 16-byte cp.async in a ring of three
// stages (111 KB, two blocks an SM); ldmatrix turns them into mma.sync
// m16n8k16 fragments (x plain, the weights transposed, since their rows
// run along the contraction).
// Each warp keeps 32 x 32 outputs of each product in float32 registers;
// the activation (erff for the exact GELU) and the gate run on those
// registers. Ragged M, I and D are predicated: a 16-byte piece that
// crosses an edge, or is not 16-byte aligned in device memory, is filled
// element by element with zeros past the edge, and rows and columns past
// the edge are not stored. Nothing is padded or copied beforehand.
// wgmma, TMA and a smaller row tile for few rows are left to a later
// version.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using evo::cp_async16;
using evo::cp_async_commit;
using evo::cp_async_wait;
using evo::ldmatrix_x4;
using evo::ldmatrix_x4_trans;
using evo::mma_bf16_16816;

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kStages = 3;
static_assert((kBM * kBK / 8) % kThreads == 0 &&
                  (kBK * kBN / 8) % kThreads == 0 && kBK % 16 == 0,
              "the loaders take whole 16-byte pieces a thread");
constexpr int kXS = kBK + 8;  // smem row strides: conflict-free ldmatrix
constexpr int kWS = kBN + 8;

struct Stage {
  __nv_bfloat16 x[kBM][kXS];
  __nv_bfloat16 w1[kBK][kWS];
  __nv_bfloat16 w2[kBK][kWS];
};

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

// Eight bf16 values from `src` into shared memory, of which the first
// `valid` exist; the rest are zeros.
__device__ __forceinline__ void fetch8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int valid,
                                       bool vec) {
  if (vec && valid >= 8) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < valid ? src[e] : __float2bfloat16_rn(0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    mlp_gate_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ w2,
                    __nv_bfloat16* __restrict__ out, int M, int D, int I,
                    int act, int vecx, int vecw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int g = lane >> 2, tq = lane & 3;
  const int nk = (D + kBK - 1) / kBK;

  auto load_stage = [&](int st, int kt) {
    Stage& s = stages[st];
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {
      const int piece = threadIdx.x + i * kThreads;
      const int r = piece / (kBK / 8), cc = (piece % (kBK / 8)) * 8;
      const int row = m0 + r, col = k0 + cc;
      const int valid = row < M ? min(max(D - col, 0), 8) : 0;
      fetch8(&s.x[r][cc], x + (int64_t)row * D + col, valid, vecx);
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN / 8) / kThreads; ++i) {
      const int piece = threadIdx.x + i * kThreads;
      const int r = piece / (kBN / 8), cc = (piece % (kBN / 8)) * 8;
      const int krow = k0 + r, col = n0 + cc;
      const int valid = krow < D ? min(max(I - col, 0), 8) : 0;
      const int64_t o = (int64_t)krow * I + col;
      fetch8(&s.w1[r][cc], w1 + o, valid, vecw);
      fetch8(&s.w2[r][cc], w2 + o, valid, vecw);
    }
  };

  float acc1[2][4][4], acc2[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = acc2[mt][nt][e] = 0.f;

  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // stage the next load overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk)
      load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const Stage& s = stages[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], &s.x[wm * 32 + mt * 16 + (lane & 15)]
                               [kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // registers 0, 1: the n-tile 2 np; 2, 3: the n-tile 2 np + 1
        uint32_t b1[4], b2[4];
        const int kr = kk * 16 + (lane & 15);
        const int nc = wn * 32 + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b1, &s.w1[kr][nc]);
        ldmatrix_x4_trans(b2, &s.w2[kr][nc]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc1[mt][2 * np], a[mt], b1);
          mma_bf16_16816(acc1[mt][2 * np + 1], a[mt], b1 + 2);
          mma_bf16_16816(acc2[mt][2 * np], a[mt], b2);
          mma_bf16_16816(acc2[mt][2 * np + 1], a[mt], b2 + 2);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + ((e & 2) ? 8 : 0);
        const int col = n0 + wn * 32 + nt * 8 + tq * 2 + (e & 1);
        if (row < M && col < I)
          out[(int64_t)row * I + col] = __float2bfloat16_rn(
              activate(acc1[mt][nt][e], act) * acc2[mt][nt][e]);
      }
}

}  // namespace

// x: (M, D), w1, w2: (D, I), out: (M, I); all bf16, contiguous. act: 0 gelu
// (erf), 1 gelu_tanh, 2 silu, 3 relu, 4 identity.
extern "C" int evo_mlp_gate_bf16(const void* x, const void* w1,
                                 const void* w2, void* out, int M, int D,
                                 int I, int act, void* stream) {
  const int vecx = (D % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int vecw = (I % 8 == 0) && ((uintptr_t)w1 % 16 == 0) &&
                   ((uintptr_t)w2 % 16 == 0);
  const int bytes = kStages * (int)sizeof(Stage);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kBM - 1) / kBM, (I + kBN - 1) / kBN);
  mlp_gate_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1,
      (const __nv_bfloat16*)w2, (__nv_bfloat16*)out, M, D, I, act, vecx,
      vecw);
  return (int)cudaGetLastError();
}
