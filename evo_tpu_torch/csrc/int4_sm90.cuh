// What the two wgmma designs of the weight-only int4 matmul share: kernel
// 8's (`int4_matmul.cu`, bf16 products) and 'dots8''s (`int4_dots8.cu`,
// int8 products). Both take persistent blocks of a producer (a warpgroup,
// or a warp) and two consumer warpgroups, whose units (column tile, step
// of 128 byte rows) are shared out in equal runs (stream-K); both stage a
// step's byte rows in 128 x 128 boxes under the 128-byte swizzle, by TMA
// or, for a weight TMA cannot take, by the producer's threads; both add a
// tile split between blocks in block order, in its last block. Here: those
// pieces, the output stores and the cache of TMA tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace evo_int4 {

constexpr int kBK = 128;         // byte rows a step: a scale group a nibble
constexpr int kBox = kBK * 128;  // a box of byte rows: 128 x 128 columns
constexpr int kProducers = 128;  // kernel 8's producer: one warpgroup
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kProducers + kConsumers;

__device__ __forceinline__ void store_y(void* y, bool out_bf16, int64_t i,
                                        float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[i] = v;
}

// 2 TM values of one row of y (or of a block's part) at consecutive
// elements from `at`; `valid` of them exist; `vec`: one vector store
template <int TM>
__device__ __forceinline__ void store_cols(void* out, bool bf16, int64_t at,
                                           const float* v, int valid,
                                           bool vec) {
  if (vec && valid >= 2 * TM) {
    if (bf16) {
      if constexpr (TM == 1)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + at) =
            evo::pack_bf16(v[0], v[1]);
      else
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
            make_uint2(evo::pack_bf16(v[0], v[1]),
                       evo::pack_bf16(v[2], v[3]));
    } else {
      if constexpr (TM == 1)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
            make_float2(v[0], v[1]);
      else
        *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 2 * TM; ++e)
    if (e < valid) store_y(out, bf16, at + e, v[e]);
}

// The tile's last contributor: y[m, n0..n0 + bn) = the `parts` parts
// added in order, then times rowscale[m] where one is given ('dots8'),
// V columns a load (V = 4 needs N % 4 == 0); a consumer thread keeps kU
// groups of V columns and four parts of each in flight
template <int V>
__device__ __forceinline__ void combine_parts(const float* part, void* y,
                                              bool bf16, int M, int N,
                                              int n0, int bn, int parts,
                                              const float* rowscale,
                                              int ctid) {
  constexpr int kU = 4, kAhead = 4;
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int nv = M * (bn / V);
  for (int i0 = ctid; i0 < nv; i0 += kU * kConsumers) {
    float v[kU][V];
    int64_t at[kU];
    bool live[kU];
    int row[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kConsumers;
      const int m = i / (bn / V), c = n0 + (i % (bn / V)) * V;
      live[u] = i < nv && c < N;
      at[u] = (int64_t)m * N + c;
      row[u] = m;
    }
    for (int s0 = 0; s0 < parts; s0 += kAhead) {
      Vec ps[kAhead][kU];
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bool on = live[u] && s0 + a < parts;
          const Vec* src = reinterpret_cast<const Vec*>(
              part + (int64_t)(s0 + a) * M * N + at[u]);
          ps[a][u] = on ? __ldcg(src) : Vec{};
        }
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float* p = reinterpret_cast<const float*>(&ps[a][u]);
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (s0 + a < parts)
              v[u][e] = s0 + a == 0 ? p[e] : __fadd_rn(v[u][e], p[e]);
        }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!live[u]) continue;
      if (rowscale != nullptr) {
        const float r = rowscale[row[u]];
#pragma unroll
        for (int e = 0; e < V; ++e) v[u][e] = __fmul_rn(v[u][e], r);
      }
      if constexpr (V == 4)
        store_cols<2>(y, bf16, at[u], v[u], 4, true);
      else
        store_y(y, bf16, at[u], v[u][0]);
    }
  }
}

// The first unit of block b of G over U units, and the block of unit u
__host__ __device__ __forceinline__ int unit_start(int b, int U, int G) {
  return (int)((int64_t)b * U / G);
}
__host__ __device__ __forceinline__ int unit_block(int u, int U, int G) {
  return (int)(((int64_t)(u + 1) * G + U - 1) / U) - 1;
}

// The copy path for a weight TMA cannot take (N % 16 != 0, misaligned):
// byte rows 128 t.. of columns n0..n0 + bn into the swizzled boxes at `wd`
// and the scales of groups t and T + t at `sd` (zeros past N), by the
// producer's kThr threads (`tid` 0..), which then meet at named barrier 2
template <int kThr>
__device__ __forceinline__ void copy_step(uint8_t* wd, float* sd,
                                          const int8_t* packed,
                                          const float* scales, int t, int T,
                                          int N, int n0, int bn, int tid) {
  const int8_t* const src = packed + (int64_t)t * kBK * N + n0;
  for (int i = tid; i < kBK * (bn / 16); i += kThr) {
    const int r = i / (bn / 16), c = i % (bn / 16);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int b = 0; b < 16 && n0 + 16 * c + b < N; ++b)
      w[b >> 2] |= (uint32_t)(uint8_t)src[(int64_t)r * N + 16 * c + b]
                   << (8 * (b & 3));
    *reinterpret_cast<uint4*>(wd + (c >> 3) * kBox + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int i = tid; i < 2 * bn; i += kThr) {
    const int h = i / bn, c = n0 + i % bn;
    sd[i] = c < N ? scales[(int64_t)(h ? T + t : t) * N + c] : 0.f;
  }
  asm volatile("bar.sync 2, %0;\n" ::"n"(kThr) : "memory");
}

// Tensor maps encoded once a (pointer, shape, box) and kept: a map is a
// function of those alone, a weight is read by every call, and the
// caching allocator hands x's few shapes the same addresses again
struct MapCache {
  struct Entry {
    const void* p = nullptr;
    int key[5] = {0, 0, 0, 0, 0};  // rows, cols, esize, box
    CUtensorMap map;
  };
  static constexpr int kSlots = 2048;
  std::mutex mu;
  Entry slots[kSlots];
};

// rows x cols of `type` (`esize` bytes an element) at p (row stride cols),
// boxes of box_cols x box_rows, under `swizzle` (the type and swizzle
// follow from esize at every call)
inline CUresult cached_map(CUtensorMap* out, const void* p, int rows,
                           int cols, CUtensorMapDataType type, int esize,
                           int box_cols, int box_rows,
                           CUtensorMapSwizzle swizzle) {
  static MapCache cache;
  const int key[5] = {rows, cols, esize, box_cols, box_rows};
  uint64_t h = (uintptr_t)p >> 4;
  for (int k : key) h = (h ^ (uint64_t)k) * 0x9e3779b97f4a7c15ull;
  MapCache::Entry& e = cache.slots[(h >> 32) % MapCache::kSlots];
  std::lock_guard<std::mutex> lock(cache.mu);
  if (e.p != p || memcmp(e.key, key, sizeof(key)) != 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const CUresult r =
        evo_sm90::encode(&e.map, type, 2, p, dims, strides, box, swizzle);
    if (r != CUDA_SUCCESS) {
      e.p = nullptr;
      return r;
    }
    e.p = p;
    memcpy(e.key, key, sizeof(key));
  }
  *out = e.map;
  return CUDA_SUCCESS;
}

// The weight's and its scales' tensor maps (boxes of 128 x 128 byte rows,
// scale rows of bn), or zeroed maps and *tma_w = 0 where TMA cannot take
// the weight (the producer copies it: `copy_step`)
inline CUresult weight_maps(CUtensorMap* wm, CUtensorMap* sm,
                            const void* packed, const void* scales, int Kp,
                            int N, int bn, int* tma_w) {
  *tma_w = N % 16 == 0 && (uintptr_t)packed % 16 == 0 &&
           (uintptr_t)scales % 16 == 0;
  memset(wm, 0, sizeof(*wm));
  memset(sm, 0, sizeof(*sm));
  if (!*tma_w) return CUDA_SUCCESS;
  CUresult r = cached_map(wm, packed, Kp / 2, N, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                          1, 128, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = cached_map(sm, scales, Kp / 128, N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   4, bn, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  return r;
}

}  // namespace evo_int4
