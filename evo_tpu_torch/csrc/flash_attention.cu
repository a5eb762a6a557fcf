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
// Design: the Hopper mainloop of `flash_sm90.cuh` with offset 0 over the
// sequence's own k and v (T = L): one block of a TMA producer warpgroup
// and two wgmma consumer warpgroups per 128-row query tile, key tiles of
// 128 up to the diagonal, the diagonal tile alone masked. q, k and v are
// read by TMA through their batch, sequence and head strides, so the
// model's views of its fused QKV projection need no copy.
//
// Time at B=1, L=8192 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// 0.89 ms, 1.6x its bound and level with SDPA's 0.90 ms.

#include "flash_sm90.cuh"

// q, k, v: (B, L, H, 128) bf16 read through element strides (batch, seq,
// head; the last axis contiguous; all strides multiples of 8 and pointers
// 16-byte aligned, as TMA asks). o: (B, L, H, 128) bf16, contiguous.
extern "C" int evo_flash_attention_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B, int L,
                                        int H, long long qsb, long long qsl,
                                        long long qsh, long long ksb,
                                        long long ksl, long long ksh,
                                        long long vsb, long long vsl,
                                        long long vsh, float scale,
                                        void* stream) {
  return evo_sm90::launch<false>(
      q, k, v, nullptr, nullptr, nullptr, o, B, L, L, H, qsb, qsl, qsh, ksb,
      ksl, ksh, vsb, vsl, vsh, scale, (cudaStream_t)stream);
}
