// Flash attention of a query segment at an offset over a KV buffer: bf16
// buffers (kernel 4), or int8 buffers with one fp32 scale per (position,
// head) (kernel 5).
//
// Replaces: evo_tpu/ops/pallas_attention.py `_flash_buffer_kernel` and
// `_flash_buffer_kernel_q8` (both called through `flash_attention_buffer`).
// Query row r of batch row b sits at absolute position offset[b] + r and
// attends the keys col <= offset[b] + r of a buffer of T positions. One
// launch per attention layer for every resumed prefill segment (3 per
// segment of evo-1) and, under the int8 KV cache, for every decode step
// (Lq = 1).
//
// Bound on the card: operations for a prefill segment, bytes for decode.
// At B=1, Lq=8192, offset=122,880, H=32, Dh=128 the two products are
// ~1.7e13 operations, ~17 ms at 989 TFLOP/s dense bf16, while the live 2.1
// GB of bf16 K and V take 0.64 ms at 3.35 TB/s. At Lq=1 over 122,880 int8
// positions the kernel reads ~1.04 GB, 0.31 ms, and computes next to
// nothing.
//
// Kernel 4 (bf16 buffers) is the Hopper mainloop of `flash_sm90.cuh` with
// the (B,) device offsets: TMA loads of the position-major (B, T, H, Dh)
// cache through its strides, wgmma products, key tiles only up to
// offset[b] + the tile's last row (capped at T), and only the tiles that
// cross a row's limit or T masked. Its time at the prefill shape above
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): 26.7 ms, 1.55x its
// bound, against 50.3 ms for SDPA under the lower-right causal bias; at
// one query row 1.16 ms.
//
// Kernel 5 (int8 buffers) keeps the first design, because TMA cannot
// dequantise on the way into shared memory: one block of 4 warps per
// (batch*head, 64-row query tile), Q in registers as mma A fragments,
// S = Q K^T and O += P V as mma.sync m16n8k16 bf16 with fp32 accumulation,
// fp32 online-softmax state with the `finite` guard, P rounded to bf16
// before P V, with the loop bound and the mask taken from the offset: a
// block walks key tiles only up to offset[b] + (its last query row), so
// reads stop at the live prefix of the buffer, and only tiles that cross a
// row's limit are masked. The offsets are a (B,) device array; nothing is
// read back to the host. The head-major int8 cache (B, H, T, Dh) is read
// through its batch, position and head strides; products of batch,
// position and stride are 64-bit (B*T*H*Dh passes 2^31 at B=4,
// T=131,072). The kernel loads 16 codes a thread, dequantises them as
// bf16(float(code) * scale) on the way into shared memory, and then runs
// the products: global memory sees one byte per element. Any T is taken:
// keys past T load as zeros and are masked. A warp whose 16 query rows all
// lie past Lq (3 of 4 at decode) skips the products. At Lq = 1 the grid is
// B*H blocks, each walking the whole live prefix alone; splitting the key
// range across blocks is left to a later version.
//
// A masked key still enters P V with p = 0, and 0 * NaN is NaN: buffers
// must hold finite values everywhere (the cache is made of zeros).

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

using evo::mma_bf16_16816;
using evo::pack_bf16;
using evo::pack_raw;

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = kHeadDim + 8;  // smem row stride: conflict-free reads

// 16 int8 codes times one scale, rounded to bf16, into 16 smem slots
__device__ __forceinline__ void dequant16(const uint4 raw, const float sc,
                                          __nv_bfloat16* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t pair = words[j >> 1] >> ((j & 1) * 16);
    w[j] = pack_bf16(__fmul_rn((float)(int8_t)(pair & 0xffu), sc),
                     __fmul_rn((float)(int8_t)((pair >> 8) & 0xffu), sc));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(kThreads)
    flash_buffer_q8_kernel(const __nv_bfloat16* __restrict__ q,
                           const int8_t* __restrict__ kbuf,
                           const int8_t* __restrict__ vbuf,
                           const float* __restrict__ kscale,
                           const float* __restrict__ vscale,
                           const int* __restrict__ offsets,
                           __nv_bfloat16* __restrict__ o, int Lq, int T,
                           int H, int64_t qsb, int64_t qsl, int64_t qsh,
                           int64_t ksb, int64_t ksl, int64_t ksh,
                           int64_t vsb, int64_t vsl, int64_t vsh,
                           float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockK][kPad];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockK][kPad];

  const int n_qt = (Lq + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // longest key range first
  const int bb = blockIdx.y / H, hh = blockIdx.y % H;
  const int off = offsets[bb];
  const __nv_bfloat16* qp = q + bb * qsb + hh * qsh;
  const int64_t kbase = bb * ksb + hh * ksh;
  const int64_t vbase = bb * vsb + hh * vsh;
  const float* ksc = kscale + ((int64_t)bb * H + hh) * T;
  const float* vsc = vscale + ((int64_t)bb * H + hh) * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q_lo = qt * kBlockQ;
  const int r0 = q_lo + warp * 16 + g;  // this thread's rows: r0, r0+8
  const bool active = q_lo + warp * 16 < Lq;

  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ((e & 1) ? 8 : 0);
      const int col = c + ((e & 2) ? 8 : 0);
      qf[kk][e] = row < Lq ? *reinterpret_cast<const uint32_t*>(
                                 qp + row * qsl + col)
                           : 0u;
    }
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // the last key any real row of this tile may see
  const int q_hi = min(q_lo + kBlockQ, Lq) - 1;
  const int last_col = min(off + q_hi, T - 1);
  const int n_kt = last_col / kBlockK + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
    const int8_t* kp = kbuf + kbase;
    const int8_t* vp = vbuf + vbase;
    for (int i = threadIdx.x; i < kBlockK * (kHeadDim / 16);
         i += kThreads) {
      const int r = i / (kHeadDim / 16);
      const int cv = (i % (kHeadDim / 16)) * 16;
      const int key = kt * kBlockK + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      float ks = 0.f, vs = 0.f;
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kp + key * ksl + cv);
        vv = *reinterpret_cast<const uint4*>(vp + key * vsl + cv);
        ks = ksc[key];
        vs = vsc[key];
      }
      dequant16(kv, ks, &Ks[r][cv]);
      dequant16(vv, vs, &Vs[r][cv]);
    }
    __syncthreads();
    if (!active) continue;  // warp-uniform: these rows are never stored

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(
            &Ks[nt * 8 + g][kk * 16 + tq * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(
            &Ks[nt * 8 + g][kk * 16 + tq * 2 + 8]);
        mma_bf16_16816(s[nt], qf[kk], bf);
      }
    }

    // a tile needs the mask when its last key passes the limit of the
    // tile's first query row, or the end of the buffer
    const int tile_end = (kt + 1) * kBlockK - 1;
    const bool masked = tile_end > off + q_lo || tile_end >= T;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + ((e & 2) ? 8 : 0);
        const int col = kt * kBlockK + nt * 8 + tq * 2 + (e & 1);
        float val = s[nt][e] * scale;
        if (masked && (col > off + row || col >= T)) val = -INFINITY;
        s[nt][e] = val;
      }

    // online softmax; the 4 threads of a quad share a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      const bool finite = m_new != -INFINITY;
      const float m_safe = finite ? m_new : 0.f;
      const float alpha = finite ? __expf(m_run[i] - m_safe) : 1.f;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = finite ? __expf(s[nt][e] - m_safe) : 0.f;
          s[nt][e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[i] = l_run[i] * alpha + rs;
      if (finite) m_run[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 and reused from the S accumulators
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int key = j * 16 + tq * 2;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        const int col = dt * 8 + g;
        uint32_t bf[2];
        bf[0] = pack_raw(Vs[key][col], Vs[key + 1][col]);
        bf[1] = pack_raw(Vs[key + 8][col], Vs[key + 9][col]);
        mma_bf16_16816(acc[dt], a, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Lq) continue;
    // every real row sees key 0, so l > 0; the floor guards a caller
    // whose offset lies outside the buffer
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* op = o + ((int64_t)bb * Lq + row) * H * kHeadDim +
                        (int64_t)hh * kHeadDim;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      const int col = dt * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(
          acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    }
  }
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
  return evo_sm90::launch(q, k, v, (const int*)offsets, o, B, Lq, T, H, qsb,
                          qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale,
                          (cudaStream_t)stream);
}

// As above with int8 k, v (strides multiples of 16) and contiguous fp32
// scales ks, vs of shape (B, H, T), on the mma.sync design.
extern "C" int evo_flash_attention_buffer_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* offsets, void* o, int B, int Lq, int T,
    int H, long long qsb, long long qsl, long long qsh, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl,
    long long vsh, float scale, void* stream) {
  dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  flash_buffer_q8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v,
      (const float*)ks, (const float*)vs, (const int*)offsets,
      (__nv_bfloat16*)o, Lq, T, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl,
      vsh, scale);
  return (int)cudaGetLastError();
}
