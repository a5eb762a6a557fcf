// The Hopper attention mainloop of kernels 3 and 4: causal flash attention
// (`flash_attention.cu`) and a query segment at an offset over a bf16 KV
// buffer (`flash_attention_buffer.cu`), bf16 in and out.
//
// Function: query row r of batch row b sits at absolute position
// offset[b] + r (offset 0 for kernel 3) and attends the keys
// col <= offset[b] + r, col < T, of T key and value positions, with fp32
// scores and softmax state; P is rounded to bf16 before P V, as the TPU
// kernels do, and the output is rounded to bf16. Head width 128.
//
// Design (sm_90a):
//  - A block takes one 128-row query tile of one (batch, head) and runs
//    three warpgroups. Warpgroup 0 is the producer: one of its threads
//    issues every TMA load, and it gives its registers up (setmaxnreg 24).
//    Warpgroups 1 and 2 are the consumers, 64 query rows each, with 240
//    registers a thread.
//  - Q (128 x 128 bf16, 32 KB) is loaded once. K and V tiles of 128 keys
//    (32 KB each) go through a ring of kStages stages, with full and free
//    mbarriers for K and V apart: S can start before V lands, and a K
//    slot is refilled as soon as its S product is done. Every tile is two
//    boxes of 64 columns under the 128-byte swizzle: a 128-row tile is two
//    16 KB atoms of 128 rows x 128 bytes.
//  - TMA reads q, k and v through 4-d tensor maps over their real strides,
//    axes ordered (Dh, H, sequence, B), so views of the fused QKV
//    projection and the position-major cache need no copy. Rows past the
//    end of a tensor arrive as zeros; the 16-byte rules of TMA (base and
//    strides) are checked by the wrappers.
//  - S = Q K^T is wgmma m64n128k16 with Q and K both K-major in shared
//    memory, 8 steps over the head. O += P V takes P from registers (the
//    S accumulator packed to bf16 is already wgmma's A fragment) and V
//    from shared memory as the MN-major (transposed) B operand, 8 steps
//    over the keys. Within a warpgroup the two overlap: the S product of
//    tile j and the P V product of tile j - 1 are issued together, the
//    softmax of tile j runs while P V is still on the tensor cores, and
//    O is rescaled after it lands.
//  - A block visits key tiles up to the one that holds offset + its last
//    real row, capped at T. Only tiles whose last key passes offset + the
//    warpgroup's first row, or T, are masked: the diagonal tile of
//    kernel 3, about two of a segment's ~1,000 tiles in kernel 4.
//  - The online softmax runs in log2 units (scale * log2(e) folded into
//    one FMA with the max, ex2.approx), with the guard that keeps a row
//    with no visible key yet from computing -inf - -inf, and a floor on l.
//  - The output is normalised, rounded, written into the warpgroup's own
//    Q rows of shared memory in the swizzled layout and stored by TMA,
//    which drops rows past the end.
//  - Query tiles are issued longest first, and all query tiles of one
//    (batch, head) are neighbours in launch order, so they walk the same
//    K and V while it sits in L2.
//
// Each source that includes this header compiles its own instance.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace evo_sm90 {
namespace {

using evo::pack_bf16;

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 128;                      // query rows a block
constexpr int kBlockK = 128;                      // keys a tile
constexpr int kStages = 2;                        // K/V ring depth
constexpr int kThreads = 384;                     // 3 warpgroups
constexpr int kTileBytes = kBlockK * kHeadDim * 2;  // 32 KB
constexpr int kAtomBytes = kTileBytes / 2;        // 128 rows x 128 bytes
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024 + 128;
constexpr int kEncodeError = 1000;  // launch() returns this + a CUresult

// full barriers of Q, K and V (the producer's one arrival and the TMA
// bytes) and free barriers of K and V (8 consumer warps)
struct Barriers {
  uint64_t q, k[kStages], v[kStages], k_free[kStages], v_free[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the shared memory of the stores issued so far may be reused (or freed)
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile under the 128-byte swizzle;
// offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most `kPending` committed groups are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Registers that an asynchronous wgmma reads or writes: this keeps the
// compiler from moving their other uses across the fence or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) B (16 x 128, smem,
// K-major); d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) B (16 x 128, smem,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// q: 128-row boxes over (B, Lq, H, 128); k, v: 128-row boxes over (B, T,
// H, 128); o: 64-row boxes over the contiguous (B, Lq, H, 128) output.
// offsets: (B,) int32 on the device, or null for offset 0.
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const int* __restrict__ offsets, int Lq, int T, int H,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  uint8_t* const Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Ks = Qs + kTileBytes;
  uint8_t* const Vs = Ks + kStages * kTileBytes;
  Barriers& bar = *reinterpret_cast<Barriers*>(Vs + kStages * kTileBytes);

  const int n_qt = (Lq + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // longest key range first
  const int bb = blockIdx.y / H, hh = blockIdx.y % H;
  const int off = offsets ? offsets[bb] : 0;
  const int q_lo = qt * kBlockQ;
  // the last key any real row of this tile may see
  const int q_hi = min(q_lo + kBlockQ, Lq) - 1;
  const int n_kt = min(off + q_hi, T - 1) / kBlockK + 1;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar.q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.k[s], 1);
      mbar_init(&bar.v[s], 1);
      mbar_init(&bar.k_free[s], 8);  // lane 0 of each consumer warp
      mbar_init(&bar.v_free[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      mbar_expect_tx(&bar.q, kTileBytes);
      tma_load(Qs, &qmap, &bar.q, 0, hh, q_lo, bb);
      tma_load(Qs + kAtomBytes, &qmap, &bar.q, 64, hh, q_lo, bb);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t free_parity = ((kt / kStages) & 1) ^ 1;
        uint8_t* const kd = Ks + s * kTileBytes;
        uint8_t* const vd = Vs + s * kTileBytes;
        mbar_wait(&bar.k_free[s], free_parity);
        mbar_expect_tx(&bar.k[s], kTileBytes);
        tma_load(kd, &kmap, &bar.k[s], 0, hh, kt * kBlockK, bb);
        tma_load(kd + kAtomBytes, &kmap, &bar.k[s], 64, hh, kt * kBlockK, bb);
        mbar_wait(&bar.v_free[s], free_parity);
        mbar_expect_tx(&bar.v[s], kTileBytes);
        tma_load(vd, &vmap, &bar.v[s], 0, hh, kt * kBlockK, bb);
        tma_load(vd + kAtomBytes, &vmap, &bar.v[s], 64, hh, kt * kBlockK, bb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    const int wq_lo = q_lo + 64 * c;       // this warpgroup's first row
    const int r0 = wq_lo + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    // this warpgroup's 64 rows of each Q atom
    uint8_t* const Qw = Qs + c * (64 * 128);

    if (wq_lo >= Lq) {
      // no real row (a short last tile): only keep the ring turning
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t ph = (kt / kStages) & 1;
        mbar_wait(&bar.k[s], ph);
        if (lane == 0) mbar_arrive(&bar.k_free[s]);
        mbar_wait(&bar.v[s], ph);
        if (lane == 0) mbar_arrive(&bar.v_free[s]);
      }
      return;
    }

    float o[64], sc[64], alpha[2];
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = sc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[j][e] = 0u;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    // S = Q K^T of tile kt, issued: 8 steps of 16 over the head, 4 in each
    // 64-column atom
    auto s_product = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(&bar.k[s], (kt / kStages) & 1);
      const uint8_t* const Kt = Ks + s * kTileBytes;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int at = (k / 4) * kAtomBytes + (k % 4) * 32;
        wgmma_ss(sc, sw128_desc(Qw + at, 16, 1024),
                 sw128_desc(Kt + at, 16, 1024), k);
      }
      wgmma_commit();
    };
    // O += P V of tile kt, issued: 8 steps of 16 keys, each 16 rows of
    // 128 bytes further
    auto pv_product = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(&bar.v[s], (kt / kStages) & 1);
      const uint8_t* const Vt = Vs + s * kTileBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_rs(o, pa[j], sw128_desc(Vt + j * 16 * 128, kAtomBytes, 1024));
      wgmma_commit();
    };
    // The online softmax of tile kt on sc, which then holds P (fp32); the
    // rescale of O is left to the caller (alpha). Units of log2:
    // p = 2^(s scale log2(e) - m). The mask only where the tile passes
    // the limit of the warpgroup's first row, or the end. sc[4j + e]
    // holds row r0 + 8 (e >> 1), key 8 j + 2 tq + (e & 1) of the tile; the
    // 4 threads of a quad share a row.
    auto softmax = [&](int kt) {
      const int key0 = kt * kBlockK;
      if (key0 + kBlockK - 1 > off + wq_lo || key0 + kBlockK - 1 >= T) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = key0 + (i / 4) * 8 + 2 * tq + (i & 1);
          const int row = r0 + ((i & 2) ? 8 : 0);
          if (col > off + row || col >= T) sc[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx * scale_log2);
        const bool finite = m_new != -INFINITY;
        const float m_safe = finite ? m_new : 0.f;
        alpha[h] = finite ? ex2(m_run[h] - m_safe) : 1.f;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            x = ex2(fmaf(x, scale_log2, -m_safe));
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_run[h] = l_run[h] * alpha[h] + rs;
        m_run[h] = m_new;
      }
    };
    // P in bf16 as wgmma A fragments: keys 16 j .. 16 j + 15 are the
    // accumulator's column blocks 2 j and 2 j + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[j][e] = pack_bf16(sc[8 * j + 2 * e], sc[8 * j + 2 * e + 1]);
    };

    mbar_wait(&bar.q, 0);
    fence_regs(sc);
    wgmma_fence();
    s_product(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&bar.k_free[0]);
    softmax(0);
    pack_p();
    // The S product of tile kt and the P V product of tile kt - 1 are
    // issued together; the softmax of tile kt runs while P V is still on
    // the tensor cores.
    for (int kt = 1; kt < n_kt; ++kt) {
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      s_product(kt);
      pv_product(kt - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&bar.k_free[kt % kStages]);
      softmax(kt);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&bar.v_free[(kt - 1) % kStages]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
      pack_p();
    }
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    pv_product(n_kt - 1);
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: normalise, round, swizzle into this warpgroup's Q rows,
    // and store the 64 rows by TMA (rows past Lq are dropped)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // every real row sees key 0, so l > 0; the floor guards a caller
      // whose offset lies outside the buffer
      const float inv = 1.f / fmaxf(l_run[h], 1e-30f);
      const int r = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint8_t* const dst = Qw + (j / 8) * kAtomBytes + r * 128 +
                             (((j % 8) ^ (r % 8)) << 4) + tq * 4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (t == 0) {
      tma_store(&omap, Qw, 0, hh, wq_lo, bb);
      tma_store(&omap, Qw + kAtomBytes, 64, hh, wq_lo, bb);
      tma_store_wait();
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at run time, so the
// library links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map over a (B, rows, H, 128) bf16 tensor with element strides
// (sb, sr, sh), axes ordered (Dh, H, rows, B), boxes of 64 columns x
// `box_rows` rows of one head, the 128-byte swizzle, zeros past the end.
// An axis of size 1 gets a packed stride: its coordinate is always 0.
CUresult encode_map(CUtensorMap* map, const void* base, int B, int rows,
                    int H, long long sb, long long sr, long long sh,
                    int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)H,
                        (cuuint64_t)rows, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sr * 2,
                           (cuuint64_t)sb * 2};
  if (H == 1) strides[0] = kHeadDim * 2;
  if (rows == 1) strides[1] = strides[0] * H;
  if (B == 1) strides[2] = strides[1] * rows;
  cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Builds the four tensor maps and launches; returns a cudaError_t, or
// kEncodeError + the CUresult of a tensor map cuTensorMapEncodeTiled
// refused.
int launch(const void* q, const void* k, const void* v, const int* offsets,
           void* o, int B, int Lq, int T, int H, long long qsb,
           long long qsl, long long qsh, long long ksb, long long ksl,
           long long ksh, long long vsb, long long vsl, long long vsh,
           float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  CUresult r = encode_map(&qm, q, B, Lq, H, qsb, qsl, qsh, kBlockQ);
  if (r == CUDA_SUCCESS)
    r = encode_map(&km, k, B, T, H, ksb, ksl, ksh, kBlockK);
  if (r == CUDA_SUCCESS)
    r = encode_map(&vm, v, B, T, H, vsb, vsl, vsh, kBlockK);
  if (r == CUDA_SUCCESS)
    r = encode_map(&om, o, B, Lq, H, (long long)Lq * H * kHeadDim,
                   (long long)H * kHeadDim, kHeadDim, 64);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  flash_sm90_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      qm, km, vm, om, offsets, Lq, T, H, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace evo_sm90
