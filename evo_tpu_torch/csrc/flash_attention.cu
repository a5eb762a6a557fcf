// Causal flash attention, bf16 in and out, fp32 softmax state.
//
// Replaces: evo_tpu/ops/pallas_attention.py `_flash_kernel` (called through
// `_flash_native` / `flash_attention_causal`): one launch per attention
// layer at fresh prefill and in scoring, 3 per forward pass of
// evo-1-8k-base (layers 8, 16, 24).
//
// Bound on the card: operations. At B=1, L=8192, H=32, Dh=128 the causal
// half of QK^T and PV is ~0.55 TFLOP, ~0.56 ms at 989 TFLOP/s dense bf16,
// while its 268 MB of q/k/v/o would take ~80 us at 3.35 TB/s.
//
// Design: one block of 4 warps per (batch*head, 64-row query tile); each
// warp owns 16 query rows. Q stays in registers as mma A fragments for the
// whole block. The block walks the key tiles of 64 up to and including the
// diagonal (tiles above it are never visited), staging K and V in shared
// memory with 16-byte loads. S = Q K^T and O += P V run on the tensor cores
// as mma.sync m16n8k16 bf16 with fp32 accumulation; P is rounded to bf16
// before P V, as `_flash_kernel` does. The online-softmax state (m, l, acc)
// is fp32 in registers, and a `finite` guard keeps a row with no valid key
// yet from computing exp(-inf - -inf). The ragged edge is masked here, not
// padded: key rows past L load as zeros and are causally masked, query rows
// past L are never stored. q, k and v are read through their batch,
// sequence and head strides, so the model's non-contiguous views of its
// fused QKV projection need no copy. Query tiles are issued longest first.
// wgmma, TMA and warp specialisation are left to a later version.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = kHeadDim + 8;  // smem row stride: conflict-free reads

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__global__ void __launch_bounds__(kThreads)
    flash_causal_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int L, int H,
                        int64_t qsb, int64_t qsl, int64_t qsh, int64_t ksb,
                        int64_t ksl, int64_t ksh, int64_t vsb, int64_t vsl,
                        int64_t vsh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockK][kPad];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockK][kPad];

  const int n_qt = (L + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int bb = blockIdx.y / H, hh = blockIdx.y % H;
  const __nv_bfloat16* qp = q + bb * qsb + hh * qsh;
  const __nv_bfloat16* kp = k + bb * ksb + hh * ksh;
  const __nv_bfloat16* vp = v + bb * vsb + hh * vsh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = qt * kBlockQ + warp * 16 + g;  // this thread's rows: r0, r0+8

  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ((e & 1) ? 8 : 0);
      const int col = c + ((e & 2) ? 8 : 0);
      qf[kk][e] = row < L ? *reinterpret_cast<const uint32_t*>(
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

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * (kHeadDim / 8); i += kThreads) {
      const int r = i / (kHeadDim / 8);
      const int cv = (i % (kHeadDim / 8)) * 8;
      const int key = kt * kBlockK + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < L) {
        kv = *reinterpret_cast<const uint4*>(kp + key * ksl + cv);
        vv = *reinterpret_cast<const uint4*>(vp + key * vsl + cv);
      }
      *reinterpret_cast<uint4*>(&Ks[r][cv]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r][cv]) = vv;
    }
    __syncthreads();

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

    const bool diag = kt == qt;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + ((e & 2) ? 8 : 0);
        const int col = kt * kBlockK + nt * 8 + tq * 2 + (e & 1);
        float val = s[nt][e] * scale;
        if (diag && col > row) val = -INFINITY;
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
    if (row >= L) continue;
    __nv_bfloat16* op = o + ((int64_t)bb * L + row) * H * kHeadDim +
                        (int64_t)hh * kHeadDim;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      const int col = dt * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(
          acc[dt][2 * i] / l_run[i], acc[dt][2 * i + 1] / l_run[i]);
    }
  }
}

}  // namespace

// q, k, v: (B, L, H, 128) bf16 read through element strides (batch, seq,
// head; the last axis contiguous; all strides multiples of 8 and pointers
// 16-byte aligned). o: (B, L, H, 128) bf16, contiguous.
extern "C" int evo_flash_attention_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B, int L,
                                        int H, long long qsb, long long qsl,
                                        long long qsh, long long ksb,
                                        long long ksl, long long ksh,
                                        long long vsb, long long vsl,
                                        long long vsh, float scale,
                                        void* stream) {
  dim3 grid((L + kBlockQ - 1) / kBlockQ, B * H);
  flash_causal_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, L, H, qsb, qsl, qsh, ksb,
      ksl, ksh, vsb, vsl, vsh, scale);
  return (int)cudaGetLastError();
}
