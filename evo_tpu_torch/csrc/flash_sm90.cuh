// The Hopper attention mainloop of kernels 3, 4 and 5: causal flash
// attention (`flash_attention.cu`), and a query segment at an offset over
// a bf16 KV buffer or an int8 one with fp32 scales
// (`flash_attention_buffer.cu`), bf16 queries and output.
//
// Function: query row r of batch row b sits at absolute position
// offset[b] + r (offset 0 for kernel 3) and attends the keys
// col <= offset[b] + r, col < T, of T key and value positions, with fp32
// scores and softmax state; P is rounded to bf16 before P V, as the TPU
// kernels do, and the output is rounded to bf16. Head width 128. An int8
// code is read as bf16(float(code) * scale), one scale per (position,
// head).
//
// Design (sm_90a):
//  - A block takes one 128-row query tile of one (batch, head). Its
//    first warpgroup (two for int8 buffers) produces: one thread issues
//    every TMA load. The last two warpgroups are the consumers, 64 query
//    rows each.
//  - Q (128 x 128 bf16, 32 KB) is loaded once. K and V tiles of 128 keys
//    (32 KB each in bf16) go through a ring of kStages stages, with full
//    and free mbarriers for K and V apart: S can start before V lands, and
//    a K slot is refilled as soon as its S product is done. Every tile is
//    two boxes of 64 columns under the 128-byte swizzle: a 128-row tile is
//    two 16 KB atoms of 128 rows x 128 bytes.
//  - bf16 buffers (kernels 3, 4): TMA writes K and V straight into the
//    ring, and the producer gives its registers up (setmaxnreg 24; the
//    consumers take 240).
//  - int8 buffers (kernel 5): TMA cannot dequantise, so it loads the
//    codes, 1 byte an element (16 KB a 128-key tile), into a second ring
//    of kRawStages stages, unswizzled; the two producer warpgroups' 256
//    threads (40 registers; the consumers take 216) take half a key row
//    each, read its scale with an ordinary load (the scales' row stride
//    T * 4 bytes is not always a multiple of 16, as TMA asks), turn its 64
//    codes into bf16(float(code) * scale) four at a time (a byte permute
//    builds the float 2^23 + code + 128, one subtraction makes it exact)
//    and write them into the swizzled K or V slot the wgmma descriptors
//    read. Each thread fences its writes for the async proxy and arrives
//    on the slot's full barrier (256 arrivals). Only the raw ring costs
//    shared memory beyond the bf16 kernel's: 64 KB. At Lq = 8192, offset
//    122,880 (H100 80GB HBM3, 700 W) one producer warpgroup dequantising
//    whole rows took 44.0-44.8 ms (chip_smoke.py, time_attention.py), two
//    38.6-38.9 ms in turns with it, and the two consumer warpgroups
//    dequantising between named barriers of theirs 51.1 ms.
//  - TMA reads q, k and v through 4-d tensor maps over their real strides,
//    axes ordered (Dh, H, sequence, B), so views of the fused QKV
//    projection, the position-major bf16 cache and the head-major int8
//    cache need no copy. Rows past the end of a tensor arrive as zeros;
//    the 16-byte rules of TMA (base and strides) are checked by the
//    wrappers.
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
//    kernel 3, about two of a segment's ~1,000 tiles in kernels 4 and 5.
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

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace evo_sm90 {
namespace {

using evo::pack_bf16;

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 128;                      // query rows a block
constexpr int kBlockK = 128;                      // keys a tile
constexpr int kStages = 2;                        // K/V ring depth
constexpr int kRawStages = 2;                     // int8 code ring depth
// warpgroups that produce: the bf16 kernel's one issues TMA loads; the
// int8 kernel's two also dequantise, half a key row a thread
template <bool kInt8>
__host__ __device__ constexpr int producers() { return kInt8 ? 2 : 1; }
template <bool kInt8>
__host__ __device__ constexpr int threads() {
  return 128 * (producers<kInt8>() + 2);
}
constexpr int kTileBytes = kBlockK * kHeadDim * 2;  // 32 KB
constexpr int kAtomBytes = kTileBytes / 2;        // 128 rows x 128 bytes
constexpr int kRawBytes = kBlockK * kHeadDim;     // 16 KB of int8 codes

template <bool kInt8>
constexpr int smem_bytes() {
  return (1 + 2 * kStages) * kTileBytes +
         (kInt8 ? 2 * kRawStages * kRawBytes : 0) + 1024 + 128;
}

// full barriers of Q, K and V (bf16: the producer's one arrival and the
// TMA bytes; int8: the producers' 256 threads), free barriers of K and V
// (8 consumer warps), and the int8 codes' full barriers (TMA bytes)
struct Barriers {
  uint64_t q, k[kStages], v[kStages], k_free[kStages], v_free[kStages],
      raw[kRawStages];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// four int8 codes (one word) times `s`, each rounded to bf16: two bf16x2
// words. The permute puts code + 128 into the low byte of the float
// 2^23 = 0x4B000000; subtracting 2^23 + 128 leaves float(code) exactly.
__device__ __forceinline__ uint2 dequant4(uint32_t w, float s) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fmul_rn(
        __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)),
                  8388736.f),
        s);
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// Codes [64 half, 64 half + 64) of row `row` of a raw int8 tile (128
// codes a row) times `s`, rounded to bf16, into row `row` of a swizzled
// bf16 tile. Each thread starts at another 16-byte piece, so the rows of
// a warp spread over the banks.
__device__ __forceinline__ void dequant_half_row(const uint8_t* raw,
                                                 uint8_t* tile, int row,
                                                 int half, float s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * half + ((i + row) & 3);  // codes 16 j .. 16 j + 15
    const uint4 w =
        *reinterpret_cast<const uint4*>(raw + row * kHeadDim + 16 * j);
    const uint2 a = dequant4(w.x, s), b = dequant4(w.y, s);
    const uint2 c = dequant4(w.z, s), d = dequant4(w.w, s);
    // bf16 columns 16 j .. 16 j + 15: 16-byte pieces 2 j and 2 j + 1, in
    // atom j / 4
    uint8_t* const base = tile + (j / 4) * kAtomBytes + row * 128;
    const int p = 2 * (j % 4);
    *reinterpret_cast<uint4*>(base + ((p ^ (row & 7)) << 4)) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(base + (((p + 1) ^ (row & 7)) << 4)) =
        make_uint4(c.x, c.y, d.x, d.y);
  }
}

// q: 128-row boxes over (B, Lq, H, 128); k, v: 128-row boxes over (B, T,
// H, 128), bf16 under the swizzle, or int8 codes unswizzled with scales
// ks, vs (B, H, T) fp32 contiguous; o: 64-row boxes over the contiguous
// (B, Lq, H, 128) output. offsets: (B,) int32 on the device, or null for
// offset 0.
template <bool kInt8>
__global__ void __launch_bounds__(threads<kInt8>(), 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ offsets, int Lq, int T, int H,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  uint8_t* const Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Ks = Qs + kTileBytes;
  uint8_t* const Vs = Ks + kStages * kTileBytes;
  uint8_t* const Raw = Vs + kStages * kTileBytes;  // int8: K then V codes
  Barriers& bar = *reinterpret_cast<Barriers*>(
      Raw + (kInt8 ? 2 * kRawStages * kRawBytes : 0));

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
      mbar_init(&bar.k[s], kInt8 ? 256 : 1);
      mbar_init(&bar.v[s], kInt8 ? 256 : 1);
      mbar_init(&bar.k_free[s], 8);  // lane 0 of each consumer warp
      mbar_init(&bar.v_free[s], 8);
    }
#pragma unroll
    for (int s = 0; s < kRawStages; ++s) mbar_init(&bar.raw[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg < producers<kInt8>()) {
    if constexpr (!kInt8) {
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
      // producers of int8 buffers: thread 0 keeps the code ring full, and
      // every thread dequantises half a key of each tile into the bf16
      // ring
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      // two threads a key row, each half of its codes
      const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
      const float* const ksc = ks + ((int64_t)bb * H + hh) * T;
      const float* const vsc = vs + ((int64_t)bb * H + hh) * T;
      auto issue_raw = [&](int kt) {
        const int r = kt % kRawStages;
        uint8_t* const dst = Raw + r * 2 * kRawBytes;
        mbar_expect_tx(&bar.raw[r], 2 * kRawBytes);
        tma_load(dst, &kmap, &bar.raw[r], 0, hh, kt * kBlockK, bb);
        tma_load(dst + kRawBytes, &vmap, &bar.raw[r], 0, hh, kt * kBlockK, bb);
      };
      if (threadIdx.x == 0) {
        mbar_expect_tx(&bar.q, kTileBytes);
        tma_load(Qs, &qmap, &bar.q, 0, hh, q_lo, bb);
        tma_load(Qs + kAtomBytes, &qmap, &bar.q, 64, hh, q_lo, bb);
        for (int kt = 0; kt < min(n_kt, kRawStages); ++kt) issue_raw(kt);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int r = kt % kRawStages, s = kt % kStages;
        const uint32_t free_parity = ((kt / kStages) & 1) ^ 1;
        const int key = kt * kBlockK + row;
        // keys past T arrive as zero codes; a zero scale keeps them zero
        const float sk = key < T ? ksc[key] : 0.f;
        const float sv = key < T ? vsc[key] : 0.f;
        const uint8_t* const src = Raw + r * 2 * kRawBytes;
        mbar_wait(&bar.raw[r], (kt / kRawStages) & 1);
        mbar_wait(&bar.k_free[s], free_parity);
        dequant_half_row(src, Ks + s * kTileBytes, row, half, sk);
        fence_async_smem();
        mbar_arrive(&bar.k[s]);
        mbar_wait(&bar.v_free[s], free_parity);
        dequant_half_row(src + kRawBytes, Vs + s * kTileBytes, row, half,
                         sv);
        fence_async_smem();
        mbar_arrive(&bar.v[s]);
        // every producer thread has read code slot r: refill it
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
        if (threadIdx.x == 0 && kt + kRawStages < n_kt)
          issue_raw(kt + kRawStages);
      }
    }
  } else {
    if constexpr (kInt8)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - producers<kInt8>();
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
        wgmma_ss<0>(sc, sw128_desc(Qw + at, 16, 1024),
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
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (t == 0) {
      tma_store(&omap, Qw, 0, hh, wq_lo, bb);
      tma_store(&omap, Qw + kAtomBytes, 64, hh, wq_lo, bb);
      tma_store_wait();
    }
  }
}

// A tensor map over a (B, rows, H, 128) tensor with element strides
// (sb, sr, sh), axes ordered (Dh, H, rows, B), boxes of `box_rows` rows of
// one head: bf16 in 64-column boxes under the 128-byte swizzle, or int8
// codes in whole 128-byte rows, unswizzled. An axis of size 1 gets a
// packed stride: its coordinate is always 0.
CUresult encode_map(CUtensorMap* map, const void* base, bool int8, int B,
                    int rows, int H, long long sb, long long sr,
                    long long sh, int box_rows) {
  const int esize = int8 ? 1 : 2;
  cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)H,
                        (cuuint64_t)rows, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(sh * esize), (cuuint64_t)(sr * esize),
                           (cuuint64_t)(sb * esize)};
  if (H == 1) strides[0] = kHeadDim * esize;
  if (rows == 1) strides[1] = strides[0] * H;
  if (B == 1) strides[2] = strides[1] * rows;
  const cuuint32_t box[4] = {int8 ? (cuuint32_t)kHeadDim : 64u, 1,
                             (cuuint32_t)box_rows, 1};
  return encode(map,
                int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, base, dims, strides, box,
                int8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                     : CU_TENSOR_MAP_SWIZZLE_128B);
}

// Builds the four tensor maps and launches; returns a cudaError_t, or
// kEncodeError + the CUresult of a tensor map cuTensorMapEncodeTiled
// refused. ks, vs: the int8 buffers' scales (null for bf16 buffers).
template <bool kInt8>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* offsets, void* o, int B, int Lq,
           int T, int H, long long qsb, long long qsl, long long qsh,
           long long ksb, long long ksl, long long ksh, long long vsb,
           long long vsl, long long vsh, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  CUresult r = encode_map(&qm, q, false, B, Lq, H, qsb, qsl, qsh, kBlockQ);
  if (r == CUDA_SUCCESS)
    r = encode_map(&km, k, kInt8, B, T, H, ksb, ksl, ksh, kBlockK);
  if (r == CUDA_SUCCESS)
    r = encode_map(&vm, v, kInt8, B, T, H, vsb, vsl, vsh, kBlockK);
  if (r == CUDA_SUCCESS)
    r = encode_map(&om, o, false, B, Lq, H, (long long)Lq * H * kHeadDim,
                   (long long)H * kHeadDim, kHeadDim, 64);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  constexpr int bytes = smem_bytes<kInt8>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_sm90_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  flash_sm90_kernel<kInt8><<<grid, threads<kInt8>(), bytes, stream>>>(
      qm, km, vm, om, ks, vs, offsets, Lq, T, H,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace evo_sm90
