#!/usr/bin/env python3
"""Smoke run of the PyTorch port (evo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (built
for an H100: the kernels target sm_90a). It

  1. prints the card (nvidia-smi name and power limit) and the versions,
     and checks that float32 matmuls run in full float32 (no TF32);
  2. builds the CUDA kernels from evo_tpu_torch/csrc and holds each
     against its plain PyTorch version at evo-1's full-width shapes and at
     ragged ones (RMSNorm; FIR + gate on the in-projection's (B, L, 3, C)
     output read in place, fresh and with a carried tail, beside the
     bias pass and layout copy the layer made before it;
     causal flash attention, at the edges of its 128-row tiles too;
     attention over a bf16 and an int8 KV buffer, up to a segment of 8,192
     queries at offset 122,880 of a 131,072-long buffer, and one query row
     for decode, with SDPA under the lower-right causal bias over the
     live prefix as kernel 4's yardstick; kernel 4's split key range at
     1 to 16 rows (more shapes, strided 16-head views, bit-equal on a
     rerun), timed at one row at offsets 8,191, 65,535 and 122,879 beside
     SDPA and in both its regimes at 1 to 16 rows; kernel 5 at one query
     row at the same offsets (with int and device offsets) and in both
     its regimes at 1 to 8 rows, and the combine kernel of the split key
     ranges against its plain twin (and bit-equal on a second run); the
     weight-only int4
     matmul at 1 to 128 rows for each projection of a layer (both its
     designs: 1, 2 streaming, 5 to 128 on wgmma), x of K <= Kp columns,
     float32 and bf16 output, bit-equal run to run, timed at 10 row counts
     of 4096 x 12288 and at 8 and 128 rows of each weight shape beside
     torch._weight_int4pack_mm; the fused
     Hyena mixer on the in-projection's output zl (1, 8192, 3, 4096) read
     in place with its bias, fresh and with a carried state, at two batch
     rows and at one chunk of odd width, beside the bias pass and layout
     copy the fused layer made before it; the cross-chunk
     prefix at 128 chunks and at a count that is no power of two, with
     and without a carried state; the
     fused MLP gate at 1 to 8,192 rows over (4096, 10928) weights, timed
     at 8,192 and 2), and times kernel, plain version, the roofline bound
     and a library yardstick with CUDA events; then kernels 2 to 7 again
     at the shapes a tp = 2 rank of phase 21 gives them (2,048 channels,
     16 heads, on the sharded layers' layouts), under the same limits,
     recorded as `tp2_shard` in each kernel's row; kernels 1, 2 and 6
     with float32 weights (param_dtype float32 under bf16 activations)
     at full width and at a tp = 2 rank's, under their bf16 limits, timed
     beside the same kernels on the weights in bf16; and kernel 8's
     autograd Function at 1, 2 and 128 rows, its gradient of x against
     the plain version's (1e-4 scaled), forward and backward timed; and
     kernel 8's other modes, 'block' (its kBlock instance, 1e-4 scaled)
     and 'dots8' (`csrc/int4_dots8.cu`, bit-equal), at 1 to 128 rows on
     every int4 weight shape of a layer, timed at 4096 x 12288 by graph
     replay in turns with 'unroll' and torch._weight_int4pack_mm;
  3. checks the whole port on a small bf16 model against the same model's
     plain PyTorch path on the CPU;
  4. scores with evo-1-8k-base at full width (32 layers, D=4096, random
     weights from a seed): 4 ragged sequences of 1,000-4,000 nt and one
     forward at B=1, L=8192, checking finite scores, padding invariance
     and the kernels' launch counts (65 / 29 / 3 per forward);
  5. generates greedily from 2 prompts of 512 nt, 64 new tokens, checking
     the launch counts (kernel 4's split and the combine kernel three
     times a decode step) and that
     prefill + decode logits agree with one
     forward over prompt + generation, and times prefill and decode steps;
  6. scores in segments with evo-1-131k-base at full width: a 12,000-nt
     sequence in one pass and in segments of 4,096 (scores and entropies
     must agree), then a 131,072-nt sequence in segments of 8,192, with
     its time, peak memory and launch counts;
  7. generates with evo-1-131k-base: a prompt prefilled in segments
     against one pass, a generation resumed from the returned cache
     against one call, and the same under the int8 KV cache, whose decode
     steps must go through the int8 kernel's split key range and the
     combine kernel;
  8. quantizes evo-1-131k-base to int4 at full width with the int8 KV
     cache, prints the memory it takes, and generates greedily from 2
     prompts of 512 nt: every decode step must launch the int4 kernel 160
     times and the prefill never, prefill + decode logits must agree with
     one forward, and the decode step is timed beside the bf16 and the
     int8 weight-only ones;
 15. (after phase 8) times one decode step of evo-1-131k-base at B=1 over
     a 131,072-slot cache of random values, bf16 and int8, at offsets
     8,191, 65,535 and 122,879, through the kernels and through the dense
     plain route they replaced, in turns, with the device ms (profiler)
     and peak allocation of each step;
  9. scores the ragged sequences of phase 4 under int8 weights, int8
     weights with int8 activations, and int4, against the bf16 scores;
 10. writes the random-init evo-1-8k-base as a sharded reference snapshot
     into a temporary directory, loads it with Evo(checkpoint_path=) and
     requires bit-equal scores (its first 8 layers at full width: 3.2 GB
     written and read where the 32 took 12.9 GB);
 11. runs `python -m evo_tpu_torch.cli.score` and `...cli.generate` with
     --random-init --quant int4 in processes of their own, and
     `...cli.serve` the same way in JSONL mode on three requests, the
     three side by side;
 12. profiles one forward at B=1, L=8192, a prefill with 8 decode steps,
     one resumed segment at offset 122,880 and single decode steps in bf16
     and int4, and one forward under the fused mixer, and prints the
     device's idle share, the kernels launched per decode step and where
     the time goes; the unfused forward, the segment and the fused
     forward must run no bias pass over the in-projection's (B, L, 3, C)
     output and no copy of it into (B, 3, C, L);
 13. (after phase 5, while its model is on the card) runs evo-1-8k-base
     with `hyena_fused_mixer=True`, same seed: a ragged batch of four
     sequences whose padded length is a multiple of the chunk and the one
     of phase 4 whose is not, one forward at B=1, L=8192 and greedy
     generation from the prompts of phase 5, checking the launch counts
     that the shape rule gives (29 fused-mixer launches and no FIR + gate
     launch where the length is a multiple of 64, the reverse where it is
     not), the logits against the unfused forward and the prefill + decode
     seam, with tokens/s and peak memory beside the unfused model's, timed
     in turns; then one forward with `hyena_pallas_prefix=True` alone (29
     prefix and 29 FIR + gate launches), and the fused MLP gate on a real
     layer's weights and input against the first half of that layer's MLP;
 16. (after phase 13, while evo-1-8k-base is on the card) serves ten
     ragged requests (96-1,500 nt prompts, 48-96 new tokens, three
     sampled, two arriving late) through `GenerationServer` on 4 slots of
     2,048 positions, decode chunks of 8 steps, prompts in chunks of 128,
     a same-length pair as one batched prefill: every request ends with
     its token count, the recorded log-probs agree with one forward over
     prompt + generation (teacher forcing, phase 5's yardstick), the
     launch counts follow from the schedule (kernel 4 at one row with
     per-row offsets three times a decode step), and a profiled step()
     makes no scalar read and one readback; prints aggregate tokens/s,
     ms a chunk and a step, the idle share, kernel 4 at B=4 with per-row
     offsets and the peak memory;
 17. (after phase 8) the same under int4 weights and the int8 KV cache: 3
     ragged prompts on 2 slots, 32 tokens each, kernel 8 160 times and
     kernel 5's split + combine 3 times a decode step, teacher forcing
     within phase 8's yardstick, and kernel 5 with device offsets beside
     an int offset; then (b) at the serve CLI's server shape (8 slots,
     decode chunks of 32 steps, prompts filled in chunks of 128): 8
     greedy requests of 64-512 nt and 16-24 new tokens, kernel 8 160
     times a decode step at 8 rows, the same teacher forcing, and one
     decode chunk profiled: device ms a step and the idle share;
 18. (after phase 16, while evo-1-8k-base is on the card) generates
     with n-gram speculative decoding (`generate_speculative`, g = 8, 32
     new tokens from a repetitive and a random 512-nt prompt) beside the
     port's greedy `generate` on the same prompts, in turns: tokens/s,
     acceptance, tokens a device call, the launch counts of the run's own
     schedule of calls, the log-probs against one forward over prompt +
     generation (phase 5's yardstick, argmax agreement >= 0.75), the ms
     and device time of one verify pass beside a decode step; kernels 4,
     5 and 8 at the verify pass's shapes (4 and 9 query rows at offsets
     512 and 8,000, 9 rows of a 4096 x 12288 int4 weight) against their
     plain versions, timed beside their bounds and the library calls;
     that the native FASTA scanner builds; and after phase 17 the same
     under int4 weights and the int8 KV cache at g = 3 and 8, 32 tokens
     (kernel 5's split and mainloop, kernel 8's two designs). For each
     model, one run at g = 8 whose drafter proposes the greedy
     continuation made wrong at set places (full, partial and no
     acceptance; replays of 3 positions and more) is held to the same
     checks and to the branches of its schedule;
 19. (after phase 18, while evo-1-8k-base is on the card) training:
     the gradients of a Hyena and an attention block of evo-1 width (B=1,
     L=2048, bf16) through kernels 1-3 against the all-plain forward's,
     each within one bf16 rounding step's yardstick, and each kernel's
     backward (its plain version's gradient, recomputed) timed beside its
     forward at L=8192; then LoRA fine-tuning of the model itself, rank 8
     on the seven default targets, B=1, L=8,192 (a window packed by
     `PackedFastaDataset`), remat on, 4 steps at lr 1e-3 on one batch:
     fresh adapters leave the logits bit-equal, the loss falls, the base
     weights do not move, every step launches kernels 1-3 in its forward
     and its recompute, the merged model agrees with the attached
     adapters within phase 5's yardstick and generates greedily; step
     time, tokens/s and peak memory;
 20. (after phase 19 frees the 7B model) full fine-tuning of the first 9
     layers of evo-1-8k-base at full width (1.8 B parameters, float32
     masters and AdamW), B=1, L=2,048, 3 steps at lr 1e-4, under the same
     checks;
 21. (after phase 20 frees its model; the references taken from phase 4's
     model before phase 19 trains it) data- and tensor-parallel execution
     as two ranks of the port on the one card over gloo, chosen
     explicitly (NCCL refuses two ranks on one card): (a) `cli.score --dp
     2` over 16 sequences, scores in input order within phase 4's 1e-2 of
     the single process's, then again after one shard's files are
     deleted, which only that shard's rank scores; (b) a tp = 2
     evo-1-8k-base on its first 9 layers (cut from 32 to keep the run in
     its time; `tools/tp_smoke.py model`): a forward at B=1, L=2,048
     within phase 5's yardstick of the single process's (argmax agreement
     >= 0.75), greedy generation under the bf16 and the int8 KV cache
     (teacher forcing within phase 5's yardstick, 4x for int8), the fused
     mixer and the prefix kernel at C/tp (their logits within the
     yardstick of the unfused tp forward's), scores under int8 weights
     within 0.05 of bf16, the
     launch counts of one process, ranks bit-equal; (c) 2 sharded train
     steps of phase 20's 9 layers, in the same launch as (b) (first loss
     within the one-rounding
     yardstick of phase 20's, the loss falls, replicated masters
     bit-equal across ranks). Its times are gloo's reduces through host
     memory on one card: nothing of NCCL or of tp across cards;
 22. (at the start of phase 6, beside its evo-1-131k-base; the 8k
     references taken from phase 4's model before phase 19 trains it)
     context parallelism as two ranks of the port on the one card over
     gloo, chosen explicitly, as one cp = 2 mesh (`tools/cp_smoke.py
     model`): (a) evo-1-8k-base, a forward at B=1, L=2,048 under each
     cp_attn ('ulysses', 'ring', 'zigzag') within phase 5's yardstick of
     the single process's (argmax agreement >= 0.75), with kernel 3 three
     times under Ulysses and never under the rings (their core is plain
     float32, as the JAX package's), and the share of each forward spent
     in the cp collectives, and 2,048 positions under the fused mixer and
     under the prefix kernel at C/cp channels (kernels 6 and 7, within
     the yardstick of the Ulysses logits); (b) greedy generation from
     phase 5's prompts, 16 tokens, under the bf16 and the int8 KV cache,
     kernels 4 / 5 three
     times a step over a 16-head cache, and teacher forcing with the
     single process's tokens within its one-rounding yardstick (4x for
     int8); (c) evo-1-131k-base, 16,384 nt in segments of 8,192 (a fresh
     first segment of 8,193, padded inside the model) within 1e-2 of the
     single process's score; (d) `cli.score --cp 2` over the first 4
     sequences of phase 21's FASTA within 1e-2 of the single-process
     scores; ranks bit-equal.
     Its times are gloo's all-to-alls and sends through host memory on
     one card: nothing of NCCL or of cp across cards;
 23. (after phase 18, beside its unchanged evo-1-8k-base; (c) checked
     after phase 20) serving, speculation and LoRA under a mesh as two
     ranks of the port on the one card over gloo, chosen explicitly
     (`tools/mesh_smoke.py model`): (a) a tp = 2 evo-1-8k-base at full
     width on its first 9 layers (cut from 32 to keep the run in its
     time) serving six ragged requests on 4 slots (prompts of
     96-1,500 nt, 16-24 new tokens, two sampled, a batched pair, one
     arriving after the second step), then two under the int8 KV cache:
     every request ends with its token count, the recorded log-probs
     within phase 5's yardstick of one single-process forward (4x for
     int8), greedy argmax agreement >= 0.75, the launch counts of the
     schedule, one step() with one host read outside the collectives and
     no scalar read, ranks equal; (b) tp = 2 speculation at g = 8 with the
     oracle drafter, under phase 18's limits; (c) LoRA rank 8 under tp = 2
     on phase 20's 9 layers, 2 steps (the first loss within phase 20's
     yardstick, a falling loss, the base bit-unchanged, adapters equal
     across ranks, kernels 1-3 under autograd); (d) dp = 2 and (e) cp = 2
     serving on the same 9 layers under (a)'s limits (each dp rank
     decoding its 2 of the 4 slots; per-slot device offsets through the
     cp decode branch); (f) `cli.serve --tp 2 --dist-backend gloo` in JSONL mode on
     a small bf16 checkpoint against a one-process run beside it. Its
     times are
     gloo's collectives through host memory on one card;
 24. (after phase 21) training under context parallelism as two ranks of
     the port on the one card over gloo, chosen explicitly, as one cp = 2
     mesh (`tools/cp_train_smoke.py model`), on phase 20's 9 layers
     (seed 20) at full width: (a) full fine-tuning, a window of L =
     2,048, 1 step under Ulysses, and a ragged L = 2,049 under Ulysses
     with remat (1 step), each leg from the seed's weights; (b) LoRA rank
     8 on the seven targets at L = 8,192 with remat, 2 steps under
     Ulysses, 1 under 'ring' and 1 under 'zigzag' (every leg but one
     under LoRA, whose gradient sum is small: a full step's took 9-20 s
     through gloo).
     Held to the single process on the same weights and batches: the
     first loss within its one-rounding yardstick, a falling loss over
     LoRA's two steps, the probed gradients (layer 0's w_in, the
     attention's wqkv, the final norm; the adapters' B factors of the
     first two) as the step sums them within the larger of the
     yardstick's relative distance and one bf16 rounding of the gradient
     (2^-8), replicated
     masters or adapters bit-equal across ranks after each step, LoRA's
     base unchanged, kernels 1-3's launches under grad (forward and
     recompute), and kernels 1-3's gradient Functions at a rank's shapes
     against their plain versions; s a step, the cp collectives' share
     of a step (forward, backward, gradient sum apart) and peak GiB a
     rank beside the single process's. Gloo through host memory: nothing
     of NCCL or of cp across cards;
 25. (after phase 20) LoRA over a quantized base and mixed types, on
     evo-1-8k-base (seed 0) at full width: (a) LoRA rank 8 on the seven
     targets over an int8 and an int4 base at full depth, B=1, L = 8,192,
     remat, 3 steps, beside the bf16 base on the same window: fresh
     adapters leave the logits bit-equal, the codes
     and scales bit-unchanged, a falling loss, the first loss within phase
     9's 0.05 / 0.15 of the bf16 base's, the launches of the schedule, s a
     step, tokens/s and peak GiB beside phase 19's; a short int4 leg at
     128 rows, where kernel 8 runs under grad through its Function (its
     launches counted), the adapter gradients within phase 19's
     one-rounding yardstick of the all-plain route's; 9 layers under int8
     weights with int8 activations, the first loss within 0.1 of bf16's;
     (b) float32 weights holding the bf16 model's values: the forward at
     B=1, L = 8,192, unfused and fused, bit-equal to the bf16 model's,
     greedy generation token-equal, the weights' bytes and the peak;
     (c) phase 20's 9 layers fully fine-tuned with float32 parameters: the
     first loss bit-equal to phase 20's, a falling loss, the step and the
     peak beside phase 20's;
 14. (after phase 6) the same with evo-1-131k-base: 12,000 nt in one pass
     and in segments of 4,096, then 131,072 nt in segments of 8,192, with
     the launch counts worked out from the segment bounds (a ragged first
     segment falls through, the aligned ones take the fused kernel with a
     carried state), time and peak memory beside the unfused run's;
 26. the FFT long-conv backend (`hyena_conv_backend='fft'`; cuFFT after
     the same FIR + gate kernel): (a, after phase 13) evo-1-8k-base, same
     seed, with `hyena_fused_mixer=True` set and ignored: one forward at
     B=1, L=8192 (65 / 29 / 3 launches of kernels 1-3, none of the fused
     mixer) within the one-rounding yardstick of the matmul backend's
     logits, both timed in turns with their peaks; (b) greedy generation
     from phase 5's prompts, 32 tokens (one FFT prefill, the modal state
     scanned for decode), its step logits within phase 5's yardstick of
     the matmul backend's teacher-forced ones, argmax agreement >= 0.75;
     (c, after phase 14) evo-1-131k-base with its published
     hyena_fft_chunk = 8,192: a forward of 32,768 positions (4 chunks)
     against the chunk at 0 and against the matmul backend, then 131,072
     nt in segments of 16,384 against phase 6's score within its drift,
     with time and peak memory.

Any failed check raises; nothing is caught. The last line of standard
output is {"ok": true, "device": {...}}; the line before it holds the
per-kernel numbers, and the one before that the card's name and power
limit.
"""

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet, dense): memory
# bytes/s, bf16 tensor-core FLOP/s, float32 (non-tensor) FLOP/s and int8
# tensor-core operations/s. The
# bounds hold for that card only; any other card name raises.
H100_SXM = dict(bytes_s=3.35e12, bf16=989e12, fp32=67e12, int8=1979e12)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


T0 = time.time()


def log(*a):
    """print, with the seconds since the start on each phase's heading."""
    if a and isinstance(a[0], str) and a[0].startswith('== '):
        a = (*a, f'[{time.time() - T0:.1f} s]')
    print(*a, flush=True)


def peaks_for(name):
    if 'H100' in name and 'HBM3' in name:      # "NVIDIA H100 80GB HBM3"
        return H100_SXM
    raise RuntimeError(f'no peak rates known for {name!r}: the bounds are '
                       'those of an H100 SXM')


def scaled_err(got, want):
    """Largest |got - want| / max(|want|, rms of want's row over the last
    axis), in float32, for outputs whose size varies from row to row."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got - want).abs()
                  / want.abs().maximum(rms).clamp(min=1e-30)).max())


def attention_flops(heads, head_dim, lq, offsets):
    """Operations of causal attention for one batch row per entry of
    `offsets`: query row r at offset o attends the o + r + 1 keys up to
    its own position, and each (row, key) pair costs two products (Q K^T
    and P V) of 2 operations a multiply-add over the head. Kernel 3 is
    offset 0."""
    return sum(4 * heads * head_dim * (lq * o + lq * (lq + 1) // 2)
               for o in offsets)


def sdpa_over_live_prefix(q, k_buf, v_buf, offset):
    """Kernel 4's function in one PyTorch call, for a scalar offset:
    SDPA over the live prefix `buf[:, :offset + Lq]` of the buffers with
    the lower-right causal bias, so query row r sees the keys
    <= offset + r. q (B, Lq, H, Dh), buffers (B, T, H, Dh); returns
    (B, H, Lq, Dh). Timed beside the kernel as its yardstick; the port
    never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    lq, live = q.shape[1], offset + q.shape[1]
    qt, kt, vt = (t.transpose(1, 2)
                  for t in (q, k_buf[:, :live], v_buf[:, :live]))
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=causal_lower_right(lq, live))


def graph_or_events_ms(torch, fns):
    """time_graph_ms, or CUDA events around the first call where the
    library's kernels refuse the graph capture."""
    try:
        return time_graph_ms(torch, fns)
    except RuntimeError as exc:
        log(f'   (no graph capture: {str(exc)[:120]}; CUDA events)')
        torch.cuda.synchronize()
        return time_ms(torch, fns[0])


def live_kv_bound_ms(peak, offsets, quantized, heads=32, head_dim=128):
    """The least time attention at one query row takes over each row's
    live prefix [0, offset] of a KV cache: its K and V bytes (int8 codes
    with a float32 scale per position and head, or bf16) over the card's
    memory rate."""
    per_pos = heads * (2 * head_dim * (1 if quantized else 2)
                       + (8 if quantized else 0))
    return 1e3 * per_pos * sum(o + 1 for o in offsets) / peak['bytes_s']


def time_ms(torch, fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def time_graph_ms(torch, fns, rounds=5):
    """Device milliseconds per call of the launches in `fns`, replayed from
    a CUDA graph, for kernels shorter than the host takes to launch one.
    Give it calls on different buffers, larger together than the 50 MB L2,
    where the real caller finds its operands cold."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / (rounds * len(fns)))
    return statistics.median(times)


# -- training (phases 19 and 20) ---------------------------------------------

def train_corpus(np, directory):
    """A FASTA of the example sequences and 16 random ones of 1,000 nt
    (seed 19): enough to pack a window of 8,193 tokens with no padding."""
    rng = np.random.default_rng(19)
    with open(os.path.join(ROOT, 'examples', 'example_seqs.fasta')) as f:
        text = f.read()
    for i in range(16):
        text += f'>random_{i}\n' + ''.join(rng.choice(list('ACGT'), 1000)) \
            + '\n'
    path = os.path.join(directory, 'train.fasta')
    with open(path, 'w') as f:
        f.write(text)
    return path


@contextlib.contextmanager
def plain_route():
    """The three kernels of the training forward replaced by their plain
    versions where the layers call them (on the card a wrapper always
    launches its kernel): the all-plain forward that the gradient check
    compares with."""
    from evo_tpu_torch.layers import attention as att_layer
    from evo_tpu_torch.layers import hyena as hyena_layer
    from evo_tpu_torch.layers import norms
    from evo_tpu_torch.ops.attention import attention_plain
    from evo_tpu_torch.ops.fir_gate import fir_gate_plain
    from evo_tpu_torch.ops.rmsnorm import rmsnorm_plain
    saved = (norms.rmsnorm, hyena_layer.fir_gate,
             att_layer.flash_attention_causal)
    norms.rmsnorm, hyena_layer.fir_gate, att_layer.flash_attention_causal = (
        rmsnorm_plain, fir_gate_plain, attention_plain)
    try:
        yield
    finally:
        (norms.rmsnorm, hyena_layer.fir_gate,
         att_layer.flash_attention_causal) = saved


def profile_step(torch, label, fn, layout_ops=None, top=10):
    """Profile fn(): the device's busy time (kernels only) against the wall
    time, and the kernels that take the most of it. With `layout_ops` =
    (B, L, C), also count the CPU ops that add a bias over a (B, L, 3, C)
    tensor or copy into a (B, 3, C, L) one (the Hyena layer's old route
    into kernel 2), as `layout` = [adds, copies]."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=layout_ops is not None) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t)
    counts = None
    if layout_ops is not None:
        B_, L_, C_ = layout_ops
        counts = [0, 0]
        for e in prof.events():
            first = [list(sh) for sh in e.input_shapes if sh][:1]
            if e.name == 'aten::add' and first == [[B_, L_, 3, C_]]:
                counts[0] += 1
            if e.name == 'aten::copy_' and first == [[B_, 3, C_, L_]]:
                counts[1] += 1
        log(f'   {label}: {counts[0]} bias adds over (B, L, 3, C), '
            f'{counts[1]} copies into (B, 3, C, L)')
    # kernels only: the GPU-side op annotations (aten::mm, ...) span the
    # kernels they launch and would count them twice
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, 'is_user_annotation', False)),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    log(f'   profile of {label}: device busy {busy_ms:.1f} ms of '
        f'{wall_ms:.1f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}); '
        f'{sum(e.count for e in ops)} kernels and copies on the device; top '
        f'kernels:')
    rows = []
    for e in ops[:top]:
        ms = e.self_device_time_total / 1e3
        rows.append(dict(kernel=e.key[:120], ms=ms, count=e.count))
        log(f'     {100 * ms / max(busy_ms, 1e-9):5.1f}%  {ms:8.2f} ms  '
            f'x{e.count:<5d} {e.key[:90]}')
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, top=rows, layout=counts)


def train_launches(steps, layers, attn_layers):
    """Launches of `steps` train steps under remat: a forward (two norms
    a block and the final one, FIR + gate a Hyena layer, flash attention
    an attention layer) and the backward's recompute of every block."""
    hyena = layers - attn_layers
    return {'rmsnorm': steps * (4 * layers + 1),
            'fir_gate': steps * 2 * hyena,
            'flash_attention': steps * 2 * attn_layers}


def time_grads(torch, fwd, plain, inputs, grad_out, reps):
    """(forward ms, backward ms, plain backward ms, backward scaled error
    against the plain gradient) for a forward with inputs `inputs`
    (requires grad), by CUDA events."""
    out = fwd()
    out = out if isinstance(out, tuple) else (out,)
    ref = plain()
    ref = ref if isinstance(ref, tuple) else (ref,)
    gk = torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    gp = torch.autograd.grad(ref, inputs, grad_out, retain_graph=True)
    err = max(scaled_err(a, b) for a, b in zip(gk, gp))
    return dict(
        forward_ms=time_ms(torch, fwd, reps=reps),
        backward_ms=time_ms(torch, lambda: torch.autograd.grad(
            out, inputs, grad_out, retain_graph=True), reps=reps),
        plain_backward_ms=time_ms(torch, lambda: torch.autograd.grad(
            ref, inputs, grad_out, retain_graph=True), reps=reps),
        grad_scaled_err=err)


# The limit of each kernel's backward against the plain gradient. The
# backward is the plain version's gradient at the same inputs, so
# bit-equal to autograd's through the plain forward, but for attention:
# its blocks' float32 gradients are added in another order than
# autograd adds them, which may move the bf16 result by one rounding
# step (2^-7 of the larger of the value and its row's rms)
GRAD_LIMITS = (('rmsnorm', 0.0), ('fir_gate', 0.0),
               ('flash_attention', 2 ** -7))


def check_kernel_grads(torch, np, kernels, smi):
    """Kernels 1-3 under autograd on the card. (a) A Hyena block and an
    attention block of evo-1 width (D=4096, 32 heads x 128, inner MLP
    10,928, bf16) at B=1, L=2048: the gradient of the next-token loss to
    every parameter through the kernels against the all-plain forward.
    The kernel forward rounds differently from the plain one (RMSNorm's
    sum order, P in bf16 before P @ V) and each backward is the plain
    version's at the inputs the forward saw, so the gradients part by
    what those roundings move downstream. The yardstick: the all-plain
    gradient after one bf16 rounding step (2^-8 of random sign) on the
    output of layer 0's first norm. Required, for every parameter: the
    relative Frobenius distance of the kernel route's gradient from the
    plain one at most the yardstick's. (b) Each kernel's backward (the
    plain version's gradient recomputed from the saved inputs) timed
    beside its forward at the training shapes of phase 19, with the
    gradient of the plain forward (autograd's own backward) beside it."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch import training
    from evo_tpu_torch.models import config_for_model
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.ops.attention import (attention_plain,
                                             flash_attention_causal)
    from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
    from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(19)
    cfg = config_for_model('evo-1-8k-base').replace(
        num_layers=2, attn_layer_idxs=(1,), hyena_layer_idxs=())
    m = model_lib.random_init(cfg, g, dev)
    ids = torch.from_numpy(np.random.default_rng(19).choice(
        np.frombuffer(b'ACGT', np.uint8), (1, 2048)).astype(np.int64)).to(dev)
    params = dict(m.named_parameters())
    sign = torch.randint(0, 2, (1, 1, cfg.hidden_size), device=dev,
                         generator=g)

    def grads(nudge=False):
        hook = m.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype)) if nudge else None
        training.set_trainable(params.values(), True)
        training.next_token_loss(m, None, ids).backward()
        training.set_trainable(params.values(), False)
        if hook is not None:
            hook.remove()
        out = {}
        for n, p in params.items():
            out[n], p.grad = p.grad, None
        return out

    _build.LAUNCHES.clear()
    got = grads()
    launched = dict(_build.LAUNCHES)
    check(launched == {'rmsnorm': 5, 'fir_gate': 1, 'flash_attention': 1},
          f'the training forward did not launch kernels 1-3: {launched}')
    with plain_route():
        _build.LAUNCHES.clear()
        want, nudged = grads(), grads(nudge=True)
        check(not _build.LAUNCHES, f'the plain route launched '
              f'{dict(_build.LAUNCHES)}')
    rows, worst = {}, 0.0
    for n in params:
        check(got[n] is not None and bool(torch.isfinite(got[n]).all())
              and float(got[n].abs().max()) > 0,
              f'{n}: no finite, nonzero gradient through the kernels')
        ref = want[n].float()
        k = float((got[n].float() - ref).norm() / ref.norm())
        y = float((nudged[n].float() - ref).norm() / ref.norm())
        rows[n] = dict(kernel=k, yardstick=y, scaled=scaled_err(got[n],
                                                                 want[n]))
        worst = max(worst, k / y)
    log(f'   gradients of a Hyena and an attention block of evo-1 width, '
        f'B=1 L=2048 bf16, kernel route against the all-plain route '
        f'(relative Frobenius distance; one bf16 rounding step at layer 0 '
        f'as the yardstick; largest ratio {worst:.3f}, limit 1):')
    for n, r in rows.items():
        log(f'     {n:32s} {r["kernel"]:.3e} yardstick {r["yardstick"]:.3e}'
            f' scaled max {r["scaled"]:.3e}')
    check(worst <= 1.0, f'a kernel-route gradient moved past the yardstick: '
          f'{worst}')
    del m, got, want, nudged, params

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    def timed(*a):
        return time_grads(torch, *a)

    D, H, Dh, L = 4096, 32, 128, 8192
    x, w = randn(L, D).requires_grad_(), randn(D).requires_grad_()
    kernels['rmsnorm']['training'] = dict(
        shape='x (8192, 4096) bf16, grads to x and w', **timed(
            lambda: rmsnorm(x, w), lambda: rmsnorm_plain(x, w), (x, w),
            (randn(L, D),), 10))
    zl = randn(1, L, 3, D).requires_grad_()
    fw, fb, b_in = (randn(3, D, 3).requires_grad_(),
                    randn(3, D).requires_grad_(), randn(3, D).requires_grad_())

    def z():
        return zl.permute(0, 2, 3, 1)
    kernels['fir_gate']['training'] = dict(
        shape='zl (1, 8192, 3, 4096) bf16 in place, grads to zl, taps and '
              'both biases', **timed(
            lambda: fir_gate(z(), fw, fb, b_in=b_in),
            lambda: fir_gate_plain(z(), fw, fb, b_in=b_in), (zl, fw, fb, b_in),
            (randn(1, D, L), randn(1, D, L)), 10))
    qkv = randn(1, L, 3, H, Dh).requires_grad_()

    def qkv_views():
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kernels['flash_attention']['training'] = dict(
        shape='q, k, v (1, 8192, 32, 128) bf16 views of one QKV tensor, '
              'grad to it', **timed(
            lambda: flash_attention_causal(*qkv_views()),
            lambda: attention_plain(*qkv_views()), (qkv,),
            (randn(1, L, H, Dh),), 3))
    for name, limit in GRAD_LIMITS:
        log(f'   {name} under autograd ({smi}): '
            f'{kernels[name]["training"]}')
        check(kernels[name]['training']['grad_scaled_err'] <= limit,
              f'{name}: backward disagrees with the plain gradient')
    del x, w, zl, fw, fb, b_in, qkv
    torch.cuda.empty_cache()
    return rows


def phase19_lora(torch, np, evo, smi, launches, nudged_forward, corpus):
    """LoRA fine-tuning of the model on the card at full width and depth:
    rank 8 on the seven default targets, B=1, L=8,192 (a window of 8,193
    tokens packed by `PackedFastaDataset`), remat on, 4 steps at lr 1e-3
    on one fixed batch."""
    from evo_tpu_torch import generate, lora, training
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.ops import _build
    module, tok = evo.model.module, evo.tokenizer
    module.config = module.config.replace(remat=True)
    ds = PackedFastaDataset([corpus], tok, seq_len=8192, batch_size=1,
                            seed=0)
    ids, mask = next(ds.iter_batches())
    check(ids.shape == (1, 8193) and float(mask.min()) == 1.0,
          f'packed batch {ids.shape}, mask {mask.min()}')
    ids_t = torch.as_tensor(ids, device='cuda').long()
    adapters = lora.init_lora(torch.Generator(device='cuda').manual_seed(19),
                              evo.model, rank=8)
    n_adapter = sum(t.numel() for t in lora.named_adapters(adapters)
                    .values())

    def checksum():
        return torch.stack([p.float().sum() for p in module.parameters()])

    before = checksum()
    base = evo.model(ids_t)[0]
    lora.attach_lora(evo.model, adapters, 16.0)
    fresh = evo.model(ids_t)[0]
    lora.detach_lora(evo.model)
    check(torch.equal(fresh, base), 'freshly attached adapters (B = 0) '
          'changed the logits')
    del base, fresh
    named = lora.named_adapters(adapters)

    def loss_and_grads():
        """A step's loss and backward with no update (a warm-up too)."""
        training.set_trainable(named.values(), True)
        lora.attach_lora(evo.model, adapters, 16.0)
        training.next_token_loss(
            evo.model, training.train_config(evo.model, adapters=True),
            ids, mask).backward()
        lora.detach_lora(evo.model)
        training.set_trainable(named.values(), False)
        for t in named.values():
            t.grad = None
    prof = profile_step(torch, 'a LoRA forward + backward (B=1, L=8,193, '
                        'remat)', loss_and_grads)
    opt = training.make_optimizer(learning_rate=1e-3)
    state = lora.init_lora_train_state(adapters, opt)
    step = lora.make_lora_train_step(evo.model, opt, alpha=16.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(4):
        t = time.time()
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
        secs.append(time.time() - t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches['lora_train_8192'] = counts = dict(_build.LAUNCHES)
    want = train_launches(4, 32, 3)
    check(counts == want, f'LoRA train steps launched {counts}, expected '
          f'{want} (forward and remat recompute)')
    lora.attach_lora(evo.model, state.lora, 16.0)
    attached = evo.model(ids_t)[0]
    floor = (nudged_forward(evo.model, ids_t) - attached).abs()
    after = float(training.next_token_loss(evo.model, None, ids, mask))
    lora.detach_lora(evo.model)
    check(all(np.isfinite(losses)) and np.isfinite(after)
          and after < losses[0], f'LoRA losses {losses}, after {after}')
    check(torch.equal(checksum(), before), 'LoRA training moved base weights')
    lora.merge_lora(evo.model, state.lora, 16.0, donate=True)
    merged = evo.model(ids_t)[0]
    diff = (merged - attached).abs()
    agree = float((merged.argmax(-1) == attached.argmax(-1)).float().mean())
    del merged, attached
    step_s = statistics.median(secs)
    res = dict(losses=losses, loss_after=after, step_s=secs,
               step_median_s=step_s, tokens_per_s=ids.size / step_s,
               peak_gib=peak, adapter_params=n_adapter,
               merge_mean_abs=float(diff.mean()),
               merge_max_abs=float(diff.max()),
               yardstick_mean=float(floor.mean()), merge_agreement=agree,
               profile=prof)
    log(f'== 19. LoRA fine-tuning of evo-1-8k-base ({smi}): rank 8 on '
        f'{len(lora.DEFAULT_TARGETS)} targets ({n_adapter:,} adapter '
        f'parameters), B=1, L=8,193, remat: losses {losses}, after '
        f'{after:.4f}; step {1e3 * step_s:.1f} ms median {secs}, '
        f'{ids.size / step_s:.0f} tokens/s, peak {peak:.2f} GiB; launches '
        f'{counts}; merged against attached logits: mean abs '
        f'{res["merge_mean_abs"]:.5f} (max {res["merge_max_abs"]:.4f}, '
        f'argmax agreement {agree:.4f}), one rounding step at layer 0 '
        f'{res["yardstick_mean"]:.5f} (limit 1x)')
    check(res['merge_mean_abs'] <= res['yardstick_mean'],
          'the merged model disagrees with the attached adapters')
    out, gen_scores = generate(['ACGT' * 64], evo.model, tok, n_tokens=16,
                               verbose=0)
    check(len(out[0]) == 16 and np.isfinite(gen_scores[0]),
          f'generation from the merged model: {out}, {gen_scores}')
    log(f'   greedy generate from the merged model: {out[0]!r}, score '
        f'{gen_scores[0]:.4f}')
    return res


def phase20_full(torch, np, smi, launches, corpus):
    """Full fine-tuning at full width over the first 9 layers of
    evo-1-8k-base (8 Hyena layers and the attention layer at 8): float32
    masters, both Adam moments, B=1, L=2,048, remat on, 3 steps at lr
    1e-4 on one fixed batch."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch import training
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.models import config_for_model
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    cfg = config_for_model('evo-1-8k-base').replace(
        num_layers=9, attn_layer_idxs=(8,), hyena_layer_idxs=(), remat=True)
    torch.cuda.reset_peak_memory_stats()
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(20), 'cuda')
    n_params = model_lib.param_count(module)
    ds = PackedFastaDataset([corpus], CharLevelTokenizer(512), seq_len=2048,
                            batch_size=1, seed=0)
    ids, mask = next(ds.iter_batches())
    opt = training.make_optimizer(learning_rate=1e-4)
    state = training.init_train_state(module, opt)
    step = training.make_train_step(module, opt)
    first = {n: t.clone() for n, t in list(state.params.items())[:4]}
    # the yardstick of phase 21's sharded first loss: how far one extra
    # bf16 rounding step at layer 0 (as phase 5's) moves the first loss
    sign = torch.randint(0, 2, (1, 1, cfg.hidden_size), device='cuda',
                         generator=torch.Generator('cuda').manual_seed(5))
    with torch.no_grad():
        base = float(training.next_token_loss(module, None, ids, mask))
        hook = module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype))
        nudged = float(training.next_token_loss(module, None, ids, mask))
        hook.remove()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(3):
        t = time.time()
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
        secs.append(time.time() - t)
    launches['full_train_2048'] = counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        after = float(training.next_token_loss(module, None, ids, mask))
    finite = all(bool(torch.isfinite(m).all()) for m in state.params.values())
    moved = all(not torch.equal(first[n], state.params[n]) for n in first)
    step_s = statistics.median(secs)
    want = train_launches(3, 9, 1)
    log(f'== 20. full fine-tuning, the first 9 layers of evo-1-8k-base at '
        f'full width ({n_params:,} parameters; {smi}): B=1, L=2,049, remat, '
        f'float32 masters + AdamW: losses {losses}, after {after:.4f}; step '
        f'{1e3 * step_s:.1f} ms median {secs}, {ids.size / step_s:.0f} '
        f'tokens/s, peak {peak:.2f} GiB; launches {counts}')
    check(counts == want, f'full train steps launched {counts}, expected '
          f'{want}')
    check(all(np.isfinite(losses)) and np.isfinite(after) and finite
          and moved and after < losses[0],
          f'full fine-tuning: losses {losses}, after {after}, finite '
          f'masters {finite}, moved {moved}')
    res = dict(params=n_params, losses=losses, loss_after=after, step_s=secs,
               step_median_s=step_s, tokens_per_s=ids.size / step_s,
               peak_gib=peak, first_loss_yardstick=abs(nudged - base),
               profile=profile_step(
                   torch, 'a fourth full fine-tuning step (update included)',
                   lambda: step(state, ids, mask)))
    del module, state, step, opt, first
    torch.cuda.empty_cache()
    return res


# -- LoRA over a quantized base, mixed types (phase 25) ------------------------

# phase 9's limits on a quantized model's distance from bf16: a first loss
# is a mean over 8,191 next-token terms, as a score is a mean of
# log-likelihoods
QUANT_LOSS_LIMITS = {'int8': 0.05, 'int8x8': 0.1, 'int4': 0.15}


def quantized_buffers(module):
    """Every buffer of the model's quantized weights (their codes and
    scales), by name."""
    from evo_tpu_torch.quant import QuantizedWeight
    return {f'{n}.{b}': t for n, m in module.named_modules()
            if isinstance(m, QuantizedWeight) for b, t in m.named_buffers()}


def lora_leg(torch, np, module, ids, mask, steps, seed, label):
    """LoRA rank 8 on the seven targets over `module` (its own config):
    fresh adapters against the bare model's logits (bit for bit), `steps`
    steps at lr 1e-3 on one batch, the codes and scales of a quantized
    base compared bit for bit after them and its other weights by an
    exact fingerprint, the launches, s a step, tokens/s and peak GiB."""
    from evo_tpu_torch import lora, training
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.tools.cp_train_smoke import fingerprint
    ids_t = torch.as_tensor(ids, device='cuda').long()
    adapters = lora.init_lora(
        torch.Generator(device='cuda').manual_seed(seed), module, rank=8)
    # the codes and scales copied to the host, so that the peak is the
    # step's own
    codes = {n: t.cpu() for n, t in quantized_buffers(module).items()}
    params = fingerprint(module.parameters())
    with torch.no_grad():
        base = model_lib.forward(module, ids_t)
        lora.attach_lora(module, adapters, 16.0)
        fresh = model_lib.forward(module, ids_t)
        lora.detach_lora(module)
    check(torch.equal(fresh, base), f'{label}: fresh adapters (B = 0) '
          'changed the logits')
    del base, fresh
    opt = training.make_optimizer(learning_rate=1e-3)
    state = lora.init_lora_train_state(adapters, opt)
    step = lora.make_lora_train_step(module, opt, alpha=16.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(steps):
        t = time.time()
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
        secs.append(time.time() - t)
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lora.attach_lora(module, state.lora, 16.0)
    with torch.no_grad():
        after = float(training.next_token_loss(module, None, ids, mask))
    lora.detach_lora(module)
    now = quantized_buffers(module)
    check(all(torch.equal(t, now[n].cpu()) for n, t in codes.items()),
          f'{label}: the codes or scales moved')
    check(torch.equal(fingerprint(module.parameters()), params),
          f'{label}: the base weights moved')
    check(all(np.isfinite(losses)) and np.isfinite(after)
          and after < losses[0], f'{label}: losses {losses}, after {after}')
    step_s = statistics.median(secs)
    return dict(losses=losses, loss_after=after, step_s=secs,
                step_median_s=step_s, tokens_per_s=ids.size / step_s,
                peak_gib=peak, launches=counts)


def phase25_quant_lora_mixed(torch, np, smi, launches, res19, res20,
                             corpus):
    """Phase 25 on evo-1-8k-base (seed 0) at full width: (a) LoRA rank 8 on
    the seven targets over an int8 and an int4 base at full depth (B=1, L =
    8,192, remat, 3 steps at lr 1e-3), beside the bf16 base on the same
    window, whose first loss theirs are held to; a short
    int4 leg at 128 rows, where kernel 8 runs under grad through its
    Function, whose adapter gradients are held against the all-plain
    route's within phase 19's one-rounding yardstick; and 9 layers under
    int8 weights with int8 activations (2 steps). (b) The model with
    float32 weights holding the bf16 model's values (param_dtype float32):
    its forward at B=1, L=8,192, unfused and fused, bit-equal to the bf16
    model's, and greedy generation token-equal. (c) Phase 20's 9 layers
    fully fine-tuned with float32 parameters: the first loss bit-equal to
    phase 20's, a falling loss."""
    from evo_tpu_torch import generate, lora, training
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.models import EvoModel, config_for_model
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.ops import int4 as int4_ops
    from evo_tpu_torch.quant import quantize_params, quantized_bytes
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    t25 = time.time()
    tok = CharLevelTokenizer(512)
    cfg = config_for_model('evo-1-8k-base').replace(remat=True)

    def bf16_model():
        """evo-1-8k-base from seed 0 (phase 4's weights), made anew for
        each leg so that each leg's peak holds its own model alone."""
        return model_lib.random_init(
            cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')

    ds = PackedFastaDataset([corpus], tok, seq_len=8191, batch_size=1,
                            seed=0)
    ids, mask = next(ds.iter_batches())
    check(ids.shape == (1, 8192), f'packed batch {ids.shape}')
    res = {}
    log(f'== 25. LoRA over a quantized base and mixed types, evo-1-8k-base '
        f'({smi}), B=1, L=8,192')

    # (a) the bf16 base, then int8 and int4 bases at full depth on the
    # same window; the bf16 leg's first loss is the one the others are
    # held to
    for mode in ('bf16', 'int8', 'int4'):
        q = (bf16_model() if mode == 'bf16' else
             quantize_params(bf16_model(), free_source=True, mode=mode))
        r = lora_leg(torch, np, q, ids, mask, 3, 25, f'25(a) {mode}')
        want = train_launches(3, 32, 3)
        check(r['launches'] == want, f'25(a) {mode}: launches '
              f'{r["launches"]}, expected {want}')
        if mode == 'bf16':
            bf16_loss = res['bf16_first_loss'] = r['losses'][0]
        gap = abs(r['losses'][0] - bf16_loss)
        r['first_loss_gap'] = gap
        r['weight_bytes'] = quantized_bytes(q)
        log(f'   (a) LoRA over the {mode} base ({r["weight_bytes"] / 1e9:.2f}'
            f' GB of weights): losses {r["losses"]}, after '
            f'{r["loss_after"]:.4f}; first loss {gap:.4f} from the bf16 '
            f'base\'s (limit {QUANT_LOSS_LIMITS.get(mode, 0.0)}); step '
            f'{1e3 * r["step_median_s"]:.1f} ms median, '
            f'{r["tokens_per_s"]:.0f} tokens/s, peak {r["peak_gib"]:.2f} GiB '
            f'(phase 19, bf16 base at L = 8,193: '
            f'{1e3 * res19["step_median_s"]:.1f} ms, '
            f'{res19["tokens_per_s"]:.0f} tokens/s, peak '
            f'{res19["peak_gib"]:.2f} GiB); launches {r["launches"]}')
        check(gap <= QUANT_LOSS_LIMITS.get(mode, 0.0), f'25(a) {mode}: '
              f'first loss {r["losses"][0]} against the bf16 base\'s '
              f'{bf16_loss}')
        res[mode] = r
        launches[f'lora_{mode}_8192'] = r['launches']
        del q
        torch.cuda.empty_cache()

    # (a) int4 at 128 rows: kernel 8 under grad
    q = quantize_params(bf16_model(), free_source=True, mode='int4')
    q.config = q.config.replace(remat=False)
    short, short_mask = ids[:, :128], mask[:, :128]
    g = torch.Generator(device='cuda').manual_seed(26)
    adapters = lora.init_lora(g, q, rank=8)
    for pairs in (p for e in adapters for p in e.values()):
        for pr in pairs.values():       # B != 0: A gets a gradient too
            pr['b'].normal_(0.0, 0.02, generator=g)
    named = lora.named_adapters(adapters)
    sign = torch.randint(0, 2, (1, 1, cfg.hidden_size), device='cuda',
                         generator=g)

    def adapter_grads(nudge=False):
        hook = q.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype)) if nudge else None
        training.set_trainable(named.values(), True)
        lora.attach_lora(q, adapters, 16.0)
        try:
            training.next_token_loss(
                q, training.train_config(q, adapters=True), short,
                short_mask).backward()
        finally:
            lora.detach_lora(q)
            training.set_trainable(named.values(), False)
            if hook is not None:
                hook.remove()
        out = torch.cat([t.grad.flatten() for t in named.values()])
        for t in named.values():
            t.grad = None
        return out

    _build.LAUNCHES.clear()
    got = adapter_grads()
    counts = dict(_build.LAUNCHES)
    want_counts = {'rmsnorm': 65, 'fir_gate': 29, 'flash_attention': 3,
                   'int4_matmul': 1, 'int4_matmul_grad': 159}
    check(counts == want_counts, f'25(a) int4 at 128 rows launched {counts},'
          f' expected {want_counts} (layer 0\'s in-projection reads the '
          f'embedding, which needs no gradient)')
    saved = int4_ops.int4_matmul
    int4_ops.int4_matmul = int4_ops.int4_matmul_plain
    try:
        with plain_route():
            _build.LAUNCHES.clear()
            want, nudged = adapter_grads(), adapter_grads(nudge=True)
            check(not _build.LAUNCHES, f'the plain route launched '
                  f'{dict(_build.LAUNCHES)}')
    finally:
        int4_ops.int4_matmul = saved
    dist = float((got - want).norm() / want.norm())
    yard = float((nudged - want).norm() / want.norm())
    opt = training.make_optimizer(learning_rate=1e-3)
    state = lora.init_lora_train_state(adapters, opt)
    step = lora.make_lora_train_step(q, opt, alpha=16.0)
    _build.LAUNCHES.clear()
    short_losses = []
    for _ in range(2):
        state, loss = step(state, short, short_mask)
        short_losses.append(float(loss))
    launches['lora_int4_128'] = counts2 = dict(_build.LAUNCHES)
    check(counts2 == {k: 2 * v for k, v in want_counts.items()},
          f'25(a) int4 steps at 128 rows launched {counts2}')
    res['int4_128'] = dict(grad_distance=dist, yardstick=yard,
                           losses=short_losses, launches=counts2)
    log(f'   (a) int4 at 128 rows (kernel 8 under grad): adapter gradients '
        f'{dist:.3e} from the all-plain route\'s (relative Frobenius; one '
        f'bf16 rounding step at layer 0 {yard:.3e}, limit 1x); 2 steps, '
        f'losses {short_losses}; launches {counts2}')
    check(dist <= yard, f'25(a) int4 at 128 rows: gradients {dist} past '
          f'the yardstick {yard}')
    check(all(np.isfinite(short_losses)), f'25(a) short int4 losses '
          f'{short_losses}')
    del q, adapters, named, state, step, got, want, nudged, adapter_grads
    torch.cuda.empty_cache()

    # (b) float32 weights holding the bf16 model's values
    cfg32 = cfg.replace(param_dtype='float32', remat=False)
    torch.cuda.reset_peak_memory_stats()
    module16 = bf16_model()
    m32 = model_lib.StripedHyena(cfg32, 'cuda')
    with torch.no_grad():
        for (n, a), (_, b) in zip(m32.named_parameters(),
                                  module16.named_parameters()):
            a.copy_(b)
    ids_t = torch.as_tensor(ids, device='cuda').long()
    out = {}

    def configure(**kw):
        module16.config = module16.config.replace(**kw)
        m32.config = m32.config.replace(**kw)

    for fused in (False, True):
        tag = 'mixed_fused_forward_8192' if fused else 'mixed_forward_8192'
        configure(hyena_fused_mixer=fused, remat=False)
        with torch.no_grad():
            want = model_lib.forward(module16, ids_t)
            _build.LAUNCHES.clear()
            got = model_lib.forward(m32, ids_t)
            torch.cuda.synchronize()
        launches[tag] = counts = dict(_build.LAUNCHES)
        core = ('hyena_mixer_w32', 29) if fused else ('fir_gate_w32', 29)
        check(counts == {'rmsnorm_w32': 65, core[0]: core[1],
                         'flash_attention': 3},
              f'25(b) {tag}: launches {counts}')
        equal = torch.equal(got, want)
        out[tag] = dict(bit_equal=equal, launches=counts)
        check(equal, f'25(b) {tag}: the float32-weight forward differs from '
              f'the bf16 model\'s (max {float((got - want).abs().max())})')
        del got, want
    configure(hyena_fused_mixer=False)
    prompts = ['ACGT' * 128, 'GATTACA' * 73 + 'A']
    gen16 = generate(prompts, EvoModel(module16.config, module16), tok,
                     n_tokens=32, verbose=0)
    gen32 = generate(prompts, EvoModel(cfg32, m32), tok, n_tokens=32,
                     verbose=0)
    check(gen16[0] == gen32[0], f'25(b) greedy generation differs: '
          f'{gen16[0]} against {gen32[0]}')
    out['generation_token_equal'] = True
    out['generation_scores'] = (gen16[1], gen32[1])
    out['weight_bytes'] = quantized_bytes(m32)
    out['bf16_weight_bytes'] = quantized_bytes(module16)
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    res['mixed'] = out
    log(f'   (b) float32 weights ({out["weight_bytes"] / 1e9:.2f} GB; bf16 '
        f'{out["bf16_weight_bytes"] / 1e9:.2f} GB) holding the bf16 model\'s'
        f' values: forward at B=1, L=8,192 bit-equal unfused and fused '
        f'({out["mixed_forward_8192"]["launches"]}, '
        f'{out["mixed_fused_forward_8192"]["launches"]}); greedy 2 x 512 + '
        f'32 token-equal, scores {gen16[1]} / {gen32[1]}; peak '
        f'{out["peak_gib"]:.2f} GiB with both models on the card')
    del m32, module16, configure
    torch.cuda.empty_cache()

    # (a) 9 layers under int8 weights and int8 activations
    cfg9 = cfg.replace(num_layers=9, attn_layer_idxs=(8,),
                       hyena_layer_idxs=())
    base9 = model_lib.random_init(
        cfg9, torch.Generator(device='cuda').manual_seed(25), 'cuda')
    with torch.no_grad():
        bf16_9 = float(training.next_token_loss(base9, None, ids, mask))
    del base9
    q9 = quantize_params(model_lib.random_init(
        cfg9.replace(weight_quant='int8', act_quant='int8'),
        torch.Generator(device='cuda').manual_seed(25), 'cuda'),
        free_source=True, mode='int8')
    r = lora_leg(torch, np, q9, ids, mask, 2, 27, '25(a) int8x8')
    want = train_launches(2, 9, 1)
    check(r['launches'] == want, f'25(a) int8x8 launches {r["launches"]}')
    r['first_loss_gap'] = gap = abs(r['losses'][0] - bf16_9)
    launches['lora_int8x8_9_layers'] = r['launches']
    res['int8x8'] = r
    log(f'   (a) LoRA over 9 layers of int8 weights with int8 activations: '
        f'losses {r["losses"]}, after {r["loss_after"]:.4f}; first loss '
        f'{gap:.4f} from the bf16 9 layers\' {bf16_9:.6f} (limit '
        f'{QUANT_LOSS_LIMITS["int8x8"]}); step '
        f'{1e3 * r["step_median_s"]:.1f} ms, peak {r["peak_gib"]:.2f} GiB')
    check(gap <= QUANT_LOSS_LIMITS['int8x8'], f'25(a) int8x8: first loss '
          f'{r["losses"][0]} against {bf16_9}')
    del q9
    torch.cuda.empty_cache()

    # (c) phase 20's 9 layers, full fine-tuning with float32 parameters
    cfg20 = config_for_model('evo-1-8k-base').replace(
        num_layers=9, attn_layer_idxs=(8,), hyena_layer_idxs=(), remat=True)
    src = model_lib.random_init(
        cfg20, torch.Generator(device='cuda').manual_seed(20), 'cuda')
    torch.cuda.reset_peak_memory_stats()
    module = model_lib.StripedHyena(cfg20.replace(param_dtype='float32'),
                                    'cuda')
    with torch.no_grad():
        for (n, a), (_, b) in zip(module.named_parameters(),
                                  src.named_parameters()):
            a.copy_(b)
    del src
    ds20 = PackedFastaDataset([corpus], tok, seq_len=2048, batch_size=1,
                              seed=0)
    ids20, mask20 = next(ds20.iter_batches())
    opt = training.make_optimizer(learning_rate=1e-4)
    state = training.init_train_state(module, opt)
    step = training.make_train_step(module, opt)
    _build.LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(3):
        t = time.time()
        state, loss = step(state, ids20, mask20)
        losses.append(float(loss))
        secs.append(time.time() - t)
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches['full_train_2048_float32'] = counts
    w20 = train_launches(3, 9, 1)
    want = {'rmsnorm_w32': w20['rmsnorm'], 'fir_gate_w32': w20['fir_gate'],
            'flash_attention': w20['flash_attention']}
    check(counts == want, f'25(c) launches {counts}, expected {want}')
    with torch.no_grad():
        after = float(training.next_token_loss(module, None, ids20, mask20))
    step_s = statistics.median(secs)
    res['full_float32'] = dict(losses=losses, loss_after=after, step_s=secs,
                               step_median_s=step_s, peak_gib=peak,
                               launches=counts)
    log(f'   (c) full fine-tuning of phase 20\'s 9 layers with float32 '
        f'parameters: losses {losses}, after {after:.4f}; first loss '
        f'{"bit-equal to" if losses[0] == res20["losses"][0] else "NOT"} '
        f'phase 20\'s {res20["losses"][0]}; step {1e3 * step_s:.1f} ms '
        f'median (phase 20: {1e3 * res20["step_median_s"]:.1f}), peak '
        f'{peak:.2f} GiB (phase 20: {res20["peak_gib"]:.2f}); launches '
        f'{counts}')
    check(losses[0] == res20['losses'][0], f'25(c) first loss {losses[0]} '
          f'against phase 20\'s {res20["losses"][0]}')
    check(all(np.isfinite(losses)) and after < losses[0],
          f'25(c) losses {losses}, after {after}')
    del module, state, step, opt
    torch.cuda.empty_cache()
    res['seconds'] = time.time() - t25
    log(f'   phase 25 seconds: {res["seconds"]:.1f}')
    return res


def tp_shard_checks(torch, log, kernels, randn, D, H, Dh, S, chunk, buffers,
                    modal_params, prefix_case, ops):
    """Kernels 2-7 at the shapes a tp = 2 rank of evo-1-8k-base gives them
    (phase 21): C/tp = 2,048 channels in kernels 2, 6 and 7, H/tp = 16
    heads in kernels 3-5, on the layouts the sharded layers leave: the
    in-projection's contiguous (B, L, 3, 2048) output read in place, q, k
    and v as views of one (B, L, 3, 16, 128) tensor, (B, T, 16, 128) bf16
    buffers and head-major int8 ones, (B, 2048, K, S) injections. Each is
    held against its plain version with phase 2's limits for it; the
    results go into its row of the kernels line as `tp2_shard`."""
    o = ops
    C, Hs = D // 2, H // 2
    # kernel 2: bit-equal, fresh and with a carried tail
    err = 0.0
    equal = 1.0
    for B, L in ((1, 1), (2, 1000), (1, 2048), (1, 8192)):
        zl, fw, fb, b_in = (randn(B, L, 3, C), randn(3, C, 3), randn(3, C),
                            randn(3, C))
        z = zl.permute(0, 2, 3, 1)
        for tail in (None, randn(B, 3, C, 2)):
            for got, want in zip(o['fir_gate'](z, fw, fb, tail, b_in=b_in),
                                 o['fir_gate_plain'](z, fw, fb, tail,
                                                     b_in=b_in)):
                torch.cuda.synchronize()
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
                equal = min(equal, float((got == want).float().mean()))
    log(f'   tp = 2 shards: fir_gate at C={C}: max abs err {err:.3e}, '
        f'equal {equal:.6f}')
    check(err == 0 and equal == 1.0,
          f'fir_gate at C=2048 disagrees: err {err}, equal {equal}')
    kernels['fir_gate']['tp2_shard'] = dict(
        max_abs_err=err, bit_equal_fraction=equal,
        shape='zl (B, L, 3, 2048) bf16 with b_in, (B, L) in (1, 1), '
              '(2, 1000), (1, 2048), (1, 8192), fresh and carried')
    del zl, z, fw, fb, b_in, tail, got, want

    # kernel 3: scaled error <= 2^-5
    err = scaled = 0.0
    for B, L in ((1, 1), (2, 129), (2, 1000), (1, 8192)):
        qkv = randn(B, L, 3, Hs, Dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        got = o['flash_attention_causal'](q, k, v)
        torch.cuda.synchronize()
        want = o['attention_plain'](q, k, v)
        err = max(err, float((got.float() - want.float()).abs().max()))
        scaled = max(scaled, scaled_err(got, want))
        del qkv, q, k, v, got, want
    log(f'   tp = 2 shards: flash_attention at {Hs} heads: max abs err '
        f'{err:.3e}, scaled {scaled:.3e}')
    check(scaled <= 2 ** -5, f'flash attention at 16 heads: {scaled}')
    kernels['flash_attention']['tp2_shard'] = dict(
        max_abs_err=err, max_scaled_err=scaled,
        shape='q, k, v views of one (B, L, 3, 16, 128) bf16 tensor, (B, L) '
              'in (1, 1), (2, 129), (2, 1000), (1, 8192)')

    # kernels 4 and 5 (the split key range and the combine kernel at one
    # query row): scaled error <= 2^-5
    err4 = err5 = scaled4 = scaled5 = 0.0
    for B, Lq, T, offset in ((2, 1, 544, (512, 530)),    # phase 21's decode
                             (2, 64, 1000, (100, 900)),
                             (1, 128, 1024, 731),
                             (2, 1, 65536, (5, 60000)),
                             (1, 4, 3000, 2000), (1, 5, 3000, 2000),
                             (1, 8192, 16384, 8192)):
        q, off, bf, i8, sc = buffers(B, Lq, T, offset, heads=Hs)
        got = o['flash_attention_buffer'](q, *bf, off)
        got8 = o['flash_attention_buffer'](q, *i8, off, *sc)
        torch.cuda.synchronize()
        want = o['attention_buffer_plain'](q, *bf, off)
        want8 = o['attention_buffer_plain'](q, *i8, off, *sc)
        err4 = max(err4, float((got.float() - want.float()).abs().max()))
        err5 = max(err5, float((got8.float() - want8.float()).abs().max()))
        scaled4 = max(scaled4, scaled_err(got, want))
        scaled5 = max(scaled5, scaled_err(got8, want8))
        del q, off, bf, i8, sc, got, got8, want, want8
    log(f'   tp = 2 shards: flash_attention_buffer at {Hs} heads: bf16 max '
        f'abs err {err4:.3e}, scaled {scaled4:.3e}; int8 max abs err '
        f'{err5:.3e}, scaled {scaled5:.3e}')
    check(scaled4 <= 2 ** -5 and scaled5 <= 2 ** -5,
          f'buffer attention at 16 heads: {scaled4}, {scaled5}')
    shape = ('q (B, Lq, 16, 128) over (B, T, 16, 128) bf16 buffers and '
             'head-major int8 ones at offsets: (2, 1, 544, (512, 530)), '
             '(2, 64, 1000, (100, 900)), (1, 128, 1024, 731), (2, 1, 65536, '
             '(5, 60000)), (1, 4 and 5, 3000, 2000), (1, 8192, 16384, 8192)')
    kernels['flash_attention_buffer']['tp2_shard'] = dict(
        max_abs_err=err4, max_scaled_err=scaled4, shape=shape)
    kernels['flash_attention_buffer_q8']['tp2_shard'] = dict(
        max_abs_err=err5, max_scaled_err=scaled5, shape=shape)
    kernels['combine_partials']['tp2_shard'] = dict(
        max_scaled_err=scaled5, shape='inside flash_attention_buffer_q8 at '
        'one query row (its tp2_shard cases with Lq = 1)')

    # kernel 6: scaled error <= 2^-6, >= 99 % equal, the state within 1e-4,
    # the FIR tail equal
    err = scaled = state = 0.0
    equal = 1.0
    for B, L, carried in ((1, 2048, False), (1, 8192, True), (2, 512, True)):
        zl = randn(B, L, 3, C)
        fw, fb = randn(3, C, 3) * 0.5, randn(3, C) * 0.1
        z, b_in = zl.permute(0, 2, 3, 1), randn(3, C)
        poles, residues = modal_params(C, S)
        d_skip = randn(C)
        st = (randn(B, 3, C, 2), randn(B, C, S, 2).float()) if carried \
            else None
        check(o['hyena_mixer_supported'](z.shape, chunk, S, 3),
              'support rule at C=2048')
        got = o['hyena_mixer'](z, fw, fb, poles, residues, d_skip,
                               chunk=chunk, state=st, b_in=b_in)
        torch.cuda.synchronize()
        want = o['hyena_mixer_plain'](z, fw, fb, poles, residues, d_skip,
                                      chunk=chunk, state=st, b_in=b_in)
        check(torch.equal(got[2], want[2]),
              'hyena_mixer FIR tail differs at C=2048')
        err = max(err, float((got[0].float() - want[0].float()).abs().max()))
        scaled = max(scaled, scaled_err(got[0], want[0]))
        equal = min(equal, float((got[0] == want[0]).float().mean()))
        state = max(state, scaled_err(got[1].flatten(2), want[1].flatten(2)))
        del zl, z, got, want, st
    log(f'   tp = 2 shards: hyena_mixer at C={C}: max abs err {err:.3e}, '
        f'scaled {scaled:.3e}, equal {equal:.6f}, modal state scaled '
        f'{state:.3e}')
    check(scaled <= 2 ** -6 and equal >= 0.99 and state <= 1e-4,
          f'hyena_mixer at C=2048: {scaled}, {equal}, {state}')
    kernels['hyena_mixer']['tp2_shard'] = dict(
        max_abs_err=err, max_scaled_err=scaled, bit_equal_fraction=equal,
        max_scaled_err_state=state,
        shape='zl (B, L, 3, 2048) bf16 with b_in, chunk 64, 8 states: (1, '
              '2048) fresh, (1, 8192) and (2, 512) carried')

    # kernel 7: scaled error <= 2e-5, with and without a carried state
    err = scaled = 0.0
    for B, K in ((1, 32), (1, 128), (2, 8)):
        case = prefix_case(B, K, C)
        for s0 in (None, randn(B, C, S, 2).float()):
            got = o['modal_prefix'](*case, s0)
            torch.cuda.synchronize()
            want = o['modal_prefix_plain'](*case, s0)
            err = max(err, max(float((a - b).abs().max())
                               for a, b in zip(got, want)))
            scaled = max(scaled, max(scaled_err(a.flatten(2), b.flatten(2))
                                     for a, b in zip(got, want)))
    log(f'   tp = 2 shards: modal_prefix at C={C}: max abs err {err:.3e}, '
        f'scaled {scaled:.3e}')
    check(scaled <= 2e-5, f'modal_prefix at C=2048: {scaled}')
    kernels['modal_prefix']['tp2_shard'] = dict(
        max_abs_err=err, max_scaled_err=scaled,
        shape='inj (B, 2048, K, 8) fp32 x 2: (1, 32) (2,048 positions at '
              'chunk 64), (1, 128), (2, 8), fresh and carried')


def float32_weight_checks(torch, log, kernels, randn, D, S, chunk, peak,
                          modal_params, ops):
    """Kernels 1, 2 and 6 with float32 weights (a model whose param_dtype
    is float32 under bf16 activations), each held against its plain
    version on the same float32 weights under its bf16 limits, at full
    width and at a tp = 2 rank's (kernel 1 runs on the full D there too;
    kernels 2 and 6 at 2,048 channels), and timed beside its bound. The
    rows `rmsnorm_w32`, `fir_gate_w32` and `hyena_mixer_w32` of the
    kernels line."""
    o = ops
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(25)

    def f32(*shape, scale=1.0):
        # float32 values that are not bf16 ones: the kernel must read them
        # as stored
        return torch.randn(*shape, device=dev, generator=g) * scale

    # kernel 1: |err| <= 1e-2 * max(1, |value|), as with a bf16 gain
    rel = err = 0.0
    for rows in (8192, 16004, 2, 1):
        x, w = randn(rows, D), f32(D)
        got, want = o['rmsnorm'](x, w), o['rmsnorm_plain'](x, w)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16, 'rmsnorm_w32 output type')
        d = (got.float() - want.float()).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float((d / want.float().abs().clamp(min=1)).max()))
    rounded = o['rmsnorm'](x, w.bfloat16())
    check(not torch.equal(rounded, got), 'rmsnorm_w32 equals the kernel on '
          'the gain rounded to bf16: the float32 gain was not read')
    log(f'   rmsnorm with a float32 gain (rows 8192, 16004, 2, 1): max abs '
        f'err {err:.3e}, scaled {rel:.3e}')
    check(rel <= 1e-2, f'rmsnorm kernel with a float32 gain disagrees: {rel}')
    x, w = randn(8192, D), f32(D)
    kernels['rmsnorm_w32'] = dict(
        name='rmsnorm_w32', route='cuda',
        source='evo_tpu_torch/csrc/rmsnorm.cu',
        replaces='evo_tpu/ops/pallas_rmsnorm.py:21', max_abs_err=err,
        max_scaled_err=rel,
        ms=time_ms(torch, lambda: o['rmsnorm'](x, w)),
        bf16_weight_ms=time_ms(torch, lambda: o['rmsnorm'](x, w.bfloat16())),
        plain_ms=time_ms(torch, lambda: o['rmsnorm_plain'](x, w)),
        bound_ms=1e3 * max((2 * x.numel() * 2 + D * 4) / peak['bytes_s'],
                           4 * x.numel() / peak['fp32']),
        bound_by='bytes', library_ms=None,
        tp2_shard=dict(max_scaled_err=rel, shape='the full D on every tp '
                       'rank (as with a bf16 gain)'),
        shape='x (8192, 4096) bf16, w (4096,) float32; no single PyTorch '
              'call takes bf16 rows with a float32 gain (F.rms_norm wants '
              'one type)')

    # kernel 2: bit-equal, fresh and carried, at C = 4096 and 2048
    err, equal = 0.0, 1.0
    for C, B, L in ((D, 1, 1), (D, 1, 3), (D, 1, 77), (D, 2, 1000),
                    (D, 1, 8192), (D // 2, 2, 1000), (D // 2, 1, 8192)):
        zl, fw, fb, b_in = (randn(B, L, 3, C), f32(3, C, 3), f32(3, C),
                            randn(3, C))
        z = zl.permute(0, 2, 3, 1)
        for tail in (None, randn(B, 3, C, 2)):
            for a, b in zip(o['fir_gate'](z, fw, fb, tail, b_in=b_in),
                            o['fir_gate_plain'](z, fw, fb, tail, b_in=b_in)):
                torch.cuda.synchronize()
                err = max(err, float((a.float() - b.float()).abs().max()))
                equal = min(equal, float((a == b).float().mean()))
    log(f'   fir_gate with float32 taps and FIR bias (C 4096 and 2048): max '
        f'abs err {err:.3e}, equal {equal:.6f}')
    check(err == 0 and equal == 1.0,
          f'fir_gate kernel with float32 taps disagrees: {err}, {equal}')
    zl, fw, fb, b_in = randn(1, 8192, 3, D), f32(3, D, 3), f32(3, D), \
        randn(3, D)
    z = zl.permute(0, 2, 3, 1)
    n_in = zl.numel()
    nbytes = (n_in + 2 * n_in // 3 + b_in.numel()) * 2 \
        + (fw.numel() + fb.numel()) * 4
    zls = [zl] + [randn(1, 8192, 3, D) for _ in range(5)]
    fw16, fb16 = fw.bfloat16(), fb.bfloat16()
    kernels['fir_gate_w32'] = dict(
        name='fir_gate_w32', route='cuda',
        source='evo_tpu_torch/csrc/fir_gate.cu',
        replaces='evo_tpu/ops/pallas_fir.py:28', max_abs_err=err,
        bit_equal_fraction=equal,
        ms=time_graph_ms(torch, [
            (lambda zz: lambda: o['fir_gate'](zz.permute(0, 2, 3, 1), fw, fb,
                                              b_in=b_in))(zz) for zz in zls]),
        bf16_weight_ms=time_graph_ms(torch, [
            (lambda zz: lambda: o['fir_gate'](zz.permute(0, 2, 3, 1), fw16,
                                              fb16, b_in=b_in))(zz)
            for zz in zls]),
        plain_ms=time_ms(torch, lambda: o['fir_gate_plain'](z, fw, fb,
                                                             b_in=b_in)),
        bound_ms=1e3 * max(nbytes / peak['bytes_s'],
                           25 * (n_in // 3) / peak['fp32']),
        bound_by='bytes', library_ms=None,
        tp2_shard=dict(max_abs_err=err, bit_equal_fraction=equal,
                       shape='zl (B, L, 3, 2048) with b_in, (2, 1000) and '
                             '(1, 8192), fresh and carried'),
        shape='zl (1, 8192, 3, 4096) bf16 with b_in bf16, taps (3, 4096, 3) '
              'and FIR bias (3, 4096) float32; ms by graph replay over six '
              'cold inputs, bf16_weight_ms the same with the weights in '
              'bf16')
    del zls

    # kernel 6: phase 2's limits (2^-6 scaled, >= 99 % equal, the state
    # within 1e-4, the FIR tail equal)
    err = scaled = state = 0.0
    equal = 1.0
    for C, B, L, carried in ((D, 1, 8192, False), (D, 1, 8192, True),
                             (D, 2, 37, True), (D // 2, 1, 2048, False),
                             (D // 2, 2, 512, True)):
        zl = randn(B, L, 3, C)
        z, b_in = zl.permute(0, 2, 3, 1), randn(3, C)
        fw, fb, d_skip = f32(3, C, 3, scale=0.5), f32(3, C, scale=0.1), \
            f32(C)
        poles, residues = modal_params(C, S)
        st = (randn(B, 3, C, 2), randn(B, C, S, 2).float()) if carried \
            else None
        got = o['hyena_mixer'](z, fw, fb, poles, residues, d_skip,
                               chunk=chunk, state=st, b_in=b_in)
        torch.cuda.synchronize()
        want = o['hyena_mixer_plain'](z, fw, fb, poles, residues, d_skip,
                                      chunk=chunk, state=st, b_in=b_in)
        check(torch.equal(got[2], want[2]),
              'hyena_mixer with float32 weights: FIR tail differs')
        err = max(err, float((got[0].float() - want[0].float()).abs().max()))
        scaled = max(scaled, scaled_err(got[0], want[0]))
        equal = min(equal, float((got[0] == want[0]).float().mean()))
        state = max(state, scaled_err(got[1].flatten(2), want[1].flatten(2)))
        del zl, z, got, want, st
    log(f'   hyena_mixer with float32 taps, FIR bias and d_skip (C 4096 and '
        f'2048): max abs err {err:.3e}, scaled {scaled:.3e}, equal '
        f'{equal:.6f}, modal state scaled {state:.3e}')
    check(scaled <= 2 ** -6 and equal >= 0.99 and state <= 1e-4,
          f'hyena_mixer kernel with float32 weights disagrees: {scaled}, '
          f'{equal}, {state}')
    zl = randn(1, 8192, 3, D)
    z, b_in = zl.permute(0, 2, 3, 1), randn(3, D)
    fw, fb, d_skip = f32(3, D, 3, scale=0.5), f32(3, D, scale=0.1), f32(D)
    poles, residues = modal_params(D, S)
    n_pos = zl.numel() // 3
    nbytes = (zl.numel() + n_pos + b_in.numel()) * 2 \
        + (fw.numel() + fb.numel() + D) * 4 + 2 * poles.numel() * 4 \
        + D * S * 2 * 4
    flops = (n_pos // chunk) * (chunk * (chunk + 1) + 8 * S * chunk) \
        + 26 * n_pos
    bound = (1e3 * nbytes / peak['bytes_s'], 1e3 * flops / peak['fp32'])
    zls = [zl] + [randn(1, 8192, 3, D) for _ in range(5)]
    w16 = (fw.bfloat16(), fb.bfloat16(), poles, residues, d_skip.bfloat16())
    w32 = (fw, fb, poles, residues, d_skip)

    def mixer_on(zz, ws):
        return lambda: o['hyena_mixer'](zz.permute(0, 2, 3, 1), *ws,
                                        chunk=chunk, b_in=b_in)
    kernels['hyena_mixer_w32'] = dict(
        name='hyena_mixer_w32', route='cuda',
        source='evo_tpu_torch/csrc/hyena_mixer.cu',
        replaces='evo_tpu/ops/pallas_hyena.py:69', max_abs_err=err,
        max_scaled_err=scaled, bit_equal_fraction=equal,
        max_scaled_err_state=state,
        ms=time_graph_ms(torch, [mixer_on(zz, w32) for zz in zls]),
        bf16_weight_ms=time_graph_ms(torch, [mixer_on(zz, w16)
                                             for zz in zls]),
        plain_ms=time_ms(torch, lambda: o['hyena_mixer_plain'](
            z, *w32, chunk=chunk, b_in=b_in), reps=5, warmup=1),
        bound_ms=max(bound),
        bound_by='bytes' if bound[0] > bound[1] else 'operations',
        library_ms=None,
        tp2_shard=dict(max_abs_err=err, max_scaled_err=scaled,
                       bit_equal_fraction=equal, max_scaled_err_state=state,
                       shape='zl (B, L, 3, 2048) with b_in: (1, 2048) fresh, '
                             '(2, 512) carried'),
        shape='zl (1, 8192, 3, 4096) bf16 with b_in bf16, taps, FIR bias '
              'and d_skip float32, chunk 64, 8 states; ms by graph replay '
              'over six cold inputs, bf16_weight_ms the same with those '
              'weights in bf16; no single PyTorch call computes this '
              'function')
    del zls, w16, w32
    for name in ('rmsnorm_w32', 'fir_gate_w32', 'hyena_mixer_w32'):
        kk = kernels[name]
        log(f"   {name}: {kk['ms']:.4f} ms with float32 weights, "
            f"{kk['bf16_weight_ms']:.4f} with bf16 ones (bound "
            f"{kk['bound_ms']:.4f} ms, plain {kk['plain_ms']:.4f})")


# Kernel 8 under autograd (LoRA over an int4 base at up to 128 rows): the
# Function's backward is the plain version's gradient to x at the inputs
# the forward saw, so it equals autograd's through the plain forward but
# for the order of float32 sums inside the recomputed product: 1e-4 of
# the larger of the value and its row's rms, kernel 8's own limit
INT4_GRAD_LIMIT = 1e-4


def int4_grad_checks(torch, log, kernels, randn, peak, int4_case,
                     int4_bound_ms, ops):
    """Kernel 8's autograd Function at M = 1, 2 and 128 rows of a
    4096 x 12288 weight: the gradient of x against autograd's through the
    plain version, within `INT4_GRAD_LIMIT`, and the forward, the backward
    (plain VJP) and the plain backward timed by CUDA events. The row
    `int4_matmul_grad` of the kernels line (its launches: phase 25's short
    int4 leg)."""
    o = ops
    rows, worst, err = {}, 0.0, 0.0
    for M in (1, 2, 128):
        x0, packed, sc = int4_case(M, 4096, 12288)
        x = x0.requires_grad_()
        gy = randn(M, 12288)
        r = time_grads(
            torch, lambda: o['int4_matmul'](x, packed, sc, torch.bfloat16),
            lambda: o['int4_matmul_plain'](x, packed, sc, torch.bfloat16),
            (x,), (gy,), 10)
        gk, = torch.autograd.grad(
            o['int4_matmul'](x, packed, sc, torch.bfloat16), x, gy)
        gp, = torch.autograd.grad(
            o['int4_matmul_plain'](x, packed, sc, torch.bfloat16), x, gy)
        r['grad_max_abs_err'] = float((gk.float() - gp.float()).abs().max())
        err = max(err, r['grad_max_abs_err'])
        r['plain_forward_ms'] = time_ms(torch, lambda: o['int4_matmul_plain'](
            x.detach(), packed, sc, torch.bfloat16), reps=5, warmup=1)
        rows[M] = r
        worst = max(worst, r['grad_scaled_err'])
        log(f'   int4_matmul under autograd, M={M}, 4096 x 12288: {r}')
    check(worst <= INT4_GRAD_LIMIT,
          f'int4_matmul backward disagrees with the plain gradient: {worst}')
    by_rows = kernels['int4_matmul']['by_rows']
    kernels['int4_matmul_grad'] = dict(
        name='int4_matmul_grad', route='cuda',
        source='evo_tpu_torch/csrc/int4_matmul.cu (forward), '
               'evo_tpu_torch/ops/int4.py Int4MatmulFunction',
        replaces='evo_tpu/ops/pallas_int4.py:87', max_abs_err=err,
        max_scaled_err=worst, ms=rows[128]['forward_ms'],
        plain_ms=rows[128]['plain_forward_ms'],
        bound_ms=int4_bound_ms(128, 4096, 4096, 12288),
        bound_by=('operations' if 2 * 128 * 4096 * 12288 / peak['bf16'] >
                  (2048 * 12288 + 32 * 12288 * 4 + 128 * (4096 + 12288) * 2)
                  / peak['bytes_s'] else 'bytes'),
        library_ms=by_rows[128].get('library_ms'), by_rows=rows,
        shape='x (128, 4096) bf16 requiring grad, packed (2048, 12288), '
              'scales (32, 12288) -> y bf16: the forward through the '
              'Function (the kernel); the errors are those of the gradient '
              'of x; by_rows: forward, backward (plain VJP) '
              'and plain backward ms at M = 1, 2, 128; library: '
              'torch._weight_int4pack_mm forward at M = 128 (phase 2)')


# Kernel 8's other modes (phase 2). 'block' rounds each dequantized weight
# to bf16 before its product and sums in float32 in another order than its
# plain version: 1e-4 of the larger of the value and its row's rms, kernel
# 8's own limit. 'dots8' takes exact integer dots and its plain version
# adds their scaled float32 sums in the kernel's order: bit-equal (the
# stated limit had the order differed: 1e-6 scaled).
def int4_mode_checks(torch, log, kernels, peak, int4_case, layer_calls,
                     tinygemm, int4_matmul, unroll_plain, block_plain,
                     dots8_plain):
    """Both modes against their plain versions at M = 1, 2, 4, 9 and 128 on
    every int4 weight shape of a layer (and two ragged ones), bit-equal run
    to run, the bf16 output the float32 one rounded; then timed by graph
    replay over cold weights at 4096 x 12288 in turns with 'unroll' and
    tinygemm, in the same calls; their rows of the kernels line. Returns
    the launches of each mode's stand-in main-path call (M = 1 at 4096 x
    12288), counted from 0: no model path calls either mode."""
    from evo_tpu_torch.ops import _build
    plains = {'block': block_plain, 'dots8': dots8_plain}
    errs = {m: [0.0, 0.0] for m in plains}
    for M, K, Kp, N in ([(M, K, Kp, N) for K, Kp, N in layer_calls
                         for M in (1, 2, 4, 9, 128)]
                        + [(5, 500, 512, 1001), (3, 130, 256, 40)]):
        x, packed, sc = int4_case(M, Kp, N)
        x = x[:, :K].contiguous()
        for mode, plain in plains.items():
            got = int4_matmul(x, packed, sc, mode=mode)
            again = int4_matmul(x, packed, sc, mode=mode)
            got16 = int4_matmul(x, packed, sc, torch.bfloat16, mode=mode)
            torch.cuda.synchronize()
            want = plain(x, packed, sc)
            e, r = float((got - want).abs().max()), scaled_err(got, want)
            check(torch.equal(got, again), f'{mode} differs run to run')
            check(torch.equal(got16, got.bfloat16()),
                  f'{mode}: the bf16 output is not the float32 one rounded')
            check(r <= 1e-4 if mode == 'block' else torch.equal(got, want),
                  f'int4_matmul mode {mode!r} M={M} K={K} N={N}: scaled '
                  f'error {r} against its plain version')
            errs[mode] = [max(errs[mode][0], e), max(errs[mode][1], r)]
    log(f'   int4_matmul block / dots8 against their plain versions (max '
        f'abs, scaled): {errs} (limits 1e-4 scaled / bit-equal)')

    K, Kp, N = 4096, 4096, 12288

    def bound(mode, M):
        nbytes = Kp // 2 * N + (Kp // 128) * N * 4 + M * K * 2 + M * N * 2
        t_ops = 2 * M * K * N / peak['int8' if mode == 'dots8' else 'bf16']
        t_bytes = nbytes / peak['bytes_s']
        return 1e3 * max(t_ops, t_bytes), (
            'operations' if t_ops > t_bytes else 'bytes')

    by_rows = {}
    for M in (1, 2, 4, 9, 128):
        ws = [int4_case(M, Kp, N) for _ in range(int(110e6 // (Kp // 2 * N))
                                                  + 1)]
        tg = [tinygemm(p, s) for _x, p, s in ws]

        def calls(name):
            if name == 'library':
                return [(lambda x=x, t=t: torch._weight_int4pack_mm(
                    x, t[0], 128, t[1])) for (x, _p, _s), t in zip(ws, tg)]
            return [(lambda c=c: int4_matmul(*c, torch.bfloat16, mode=name))
                    for c in ws]
        times = collections.defaultdict(list)
        for name in ('unroll', 'block', 'dots8', 'library', 'library',
                     'dots8', 'block', 'unroll'):
            times[name].append(time_graph_ms(torch, calls(name)))
        row = {name: t for name, t in times.items()}
        for mode, plain in plains.items():
            row[f'{mode}_plain_ms'] = time_ms(torch, lambda: plain(
                *ws[0], torch.bfloat16), reps=3, warmup=1)
            row[f'{mode}_bound'] = bound(mode, M)
        by_rows[M] = row
        del ws, tg
    log(f'   int4_matmul modes at 4096 x 12288 by rows (graph replay ms, in '
        f'turns; library: torch._weight_int4pack_mm): {by_rows}')

    launches = {}
    x, packed, sc = int4_case(1, Kp, N)
    for mode in plains:
        _build.LAUNCHES.clear()
        int4_matmul(x, packed, sc, torch.bfloat16, mode=mode)
        torch.cuda.synchronize()
        launches[f'int4_{mode}_call'] = dict(_build.LAUNCHES)
        check(launches[f'int4_{mode}_call'] == {f'int4_matmul_{mode}': 1},
              f'launches {launches[f"int4_{mode}_call"]}')
        row = by_rows[1]
        bound_ms, bound_by = row[f'{mode}_bound']
        kernels[f'int4_matmul_{mode}'] = dict(
            name=f'int4_matmul_{mode}', route='cuda',
            source=('evo_tpu_torch/csrc/int4_matmul.cu' if mode == 'block'
                    else 'evo_tpu_torch/csrc/int4_dots8.cu'),
            replaces=('evo_tpu/ops/pallas_int4.py:163' if mode == 'block'
                      else 'evo_tpu/ops/pallas_int4.py:115'),
            max_abs_err=errs[mode][0], max_scaled_err=errs[mode][1],
            ms=min(row[mode]), plain_ms=row[f'{mode}_plain_ms'],
            bound_ms=bound_ms, bound_by=bound_by,
            # no single PyTorch call computes either function; tinygemm,
            # the nearest, is in by_rows
            library_ms=None,
            by_rows={M: dict(ms=r[mode], unroll_ms=r['unroll'],
                             tinygemm_ms=r['library'],
                             plain_ms=r[f'{mode}_plain_ms'],
                             bound_ms=r[f'{mode}_bound'][0],
                             bound_by=r[f'{mode}_bound'][1])
                     for M, r in by_rows.items()},
            shape='x (1, 4096) bf16, packed (2048, 12288) int8, scales '
                  '(32, 12288) fp32 -> y bf16 (by_rows: M = 1, 2, 4, 9, 128, '
                  'each time graph replay in turns, twice)')
    return launches


def phase21_inputs(torch, np, evo, prompts, seqs, nudged_forward, d):
    """What phase 21's ranks are held to, from the single-process
    evo-1-8k-base (seed 0) while it is on the card and unchanged: one
    forward at B=1, L=2,048 of its first 9 layers (the depth of phase 21
    (b)) and its one-rounding yardstick, phase 5's prompts, phase 4's
    ragged sequences, and a FASTA of 16 sequences with their scores in
    batches of 4; and the same forward and yardstick at full depth, which
    phase 22 reads. Written to `d`; the logits leave the card."""
    from evo_tpu_torch.io.fasta import read_fasta, write_fasta
    from evo_tpu_torch.scoring import score_sequences
    from evo_tpu_torch.tools.tp_smoke import NINE
    rng = np.random.default_rng(21)
    ids = torch.from_numpy(rng.integers(65, 85, (1, 2048)))
    logits = evo.model(ids)[0]
    floor = float((nudged_forward(evo.model, ids) - logits).abs().mean())
    nine = truncated(evo.model, NINE)
    logits9 = nine(ids)[0]
    floor9 = float((nudged_forward(nine, ids) - logits9).abs().mean())
    torch.save({'ids': ids, 'logits': logits.float().cpu(),
                'logits9': logits9.float().cpu(), 'prompts': prompts,
                'seqs': seqs}, os.path.join(d, 'model_in.pt'))
    del logits, logits9, nine
    _, examples = read_fasta(os.path.join(ROOT, 'examples',
                                          'example_seqs.fasta'))
    # the 3 examples, the 4 ragged sequences, and 9 of their prefixes
    fasta16 = examples + seqs + [s[:n] for s, n in zip(
        seqs * 3, (100, 333, 512, 777, 1024, 1500, 2048, 2999, 3500))]
    check(len(fasta16) == 16 and max(map(len, fasta16)) <= 8192,
          'phase 21 FASTA')
    path = os.path.join(d, 'sixteen.fasta')
    write_fasta(path, [f's{i}' for i in range(16)], fasta16)
    scores = []
    for i in range(0, 16, 4):
        scores += score_sequences(fasta16[i:i + 4], evo.model, evo.tokenizer)
    return dict(floor=floor, floor9=floor9, fasta=path, seqs=fasta16,
                scores=scores)


def phase21_parallel(torch, np, smi, launches, ref, res20, corpus, d):
    """Data- and tensor-parallel execution: two ranks of the port on the
    one card over gloo (chosen explicitly; NCCL refuses two ranks on one
    card), launched with torchrun's environment. These times are gloo's
    host-memory reduces on one card, and say nothing of NCCL or of tensor
    parallelism across cards."""
    from evo_tpu_torch.parallel.distributed import launch_local
    env = dict(os.environ, PYTHONPATH=ROOT)
    log(f'== 21. parallel execution ({smi}): 2 ranks on one card, '
        f'torch.distributed backend gloo (passed explicitly)')
    out = {}

    def run(argv, tag):
        t = time.time()
        logs = launch_local(argv, 2, env=env, timeout=900,
                            log_dir=os.path.join(d, tag))
        return logs, time.time() - t

    def rank_json(part):
        out = []
        for r in (0, 1):
            with open(os.path.join(d, f'{part}_rank{r}.json')) as f:
                out.append(json.load(f))
        return out

    # (a) sharded scoring through the CLI: 2 replicas of the whole model,
    # 8 sequences each, then a resume after one shard's files are deleted
    tsv = os.path.join(d, 'cli', 'scores.tsv')
    os.makedirs(os.path.dirname(tsv))
    argv = ['-m', 'evo_tpu_torch.cli.score', '--dp', '2', '--random-init',
            '--dist-backend', 'gloo', '--batch-size', '4', '--input-fasta',
            ref['fasta'], '--output-tsv', tsv]
    _, secs = run(argv, 'cli1')
    with open(tsv) as f:
        rows = [ln.rstrip('\n').split('\t') for ln in f][1:]
    got = [float(r[1]) for r in rows]
    worst = max(abs(a - b) for a, b in zip(got, ref['scores']))
    log(f'   (a) cli.score --dp 2 over {len(rows)} sequences (batch 4): '
        f'{secs:.1f} s; largest difference from the single-process scores '
        f'{worst:.2e} (limit 1e-2, phase 4\'s)')
    check([r[0] for r in rows] == ref['seqs'] and worst <= 1e-2
          and all(np.isfinite(got)), f'sharded CLI scores {got}')
    work = tsv + '.work'
    for name in ('shard_1.csv', 'shard_1.done'):
        os.remove(os.path.join(work, name))
    with open(tsv) as f:
        before = f.read()
    logs, secs2 = run(argv, 'cli2')
    skipped = 'shard 0: done before, skipped' in logs[0]
    rescored = 'shard 1: scored 8 sequences' in logs[1]
    log(f'   (a) resumed after shard 1\'s files were deleted: {secs2:.1f} s; '
        f'rank 0 skipped shard 0: {skipped}, rank 1 scored shard 1 again: '
        f'{rescored}')
    with open(tsv) as f:
        after = f.read()
    check(skipped and rescored and 'scored' not in logs[0]
          and after == before, 'the sharded CLI did not resume')
    out['a'] = dict(seconds=secs, resume_seconds=secs2, max_diff=worst)

    # (b) a tp = 2 evo-1-8k-base on its first 9 layers (8 Hyena layers,
    # the attention at 8), and (c) the sharded train step, in one launch
    with open(os.path.join(d, 'train_in.json'), 'w') as f:
        json.dump({'corpus': corpus}, f)
    _, secs_bc = run(['-m', 'evo_tpu_torch.tools.tp_smoke', 'model+train',
                      d], 'model')
    r0, r1 = rank_json('model')
    per_forward = {'rmsnorm': 19, 'fir_gate': 8, 'flash_attention': 1}
    n_new = 16
    want_gen = {'rmsnorm': 19 * n_new, 'fir_gate': 8, 'flash_attention': 1,
                'flash_attention_buffer': n_new - 1,
                'combine_partials': n_new - 1}
    want_gen8 = dict(want_gen, flash_attention_buffer_q8=n_new - 1,
                     combine_partials=n_new - 1)
    del want_gen8['flash_attention_buffer']
    logits = [torch.load(os.path.join(d, f'logits_rank{r}.pt'))
              for r in (0, 1)]
    for r, res in enumerate((r0, r1)):
        m = res['part']
        t_b, t_8 = m['teacher_bf16'], m['teacher_int8']
        log(f'   (b) rank {r}: weights {m["weight_gib"]:.2f} GiB, made in '
            f'{m["init_s"]:.1f} s; 9 layers: forward B=1 L=2048 '
            f'{m["forward_ms"]:.1f} ms; again with each of the 18 reduces '
            f'between device syncs '
            f'{m["forward_instrumented_ms"]:.1f} ms, of which the reduces '
            f'{m["reduce_ms"]:.1f} ms, {100 * m["reduce_share"]:.1f} %; '
            f'against the single process: mean abs '
            f'{m["forward_mean_abs"]:.5f} (yardstick {ref["floor9"]:.5f}), '
            f'max {m["forward_max_abs"]:.4f}, argmax agreement '
            f'{m["forward_argmax_agree"]:.4f}; decode step '
            f'{m["decode_step_ms"]:.2f} ms at B=2; generate 2 x 512 + '
            f'{n_new}: '
            f'bf16 {m["generate_bf16_s"]:.2f} s, teacher forcing {t_b}; '
            f'int8 KV {m["generate_int8_s"]:.2f} s, {t_8}; fused mixer, '
            f'L=2048: mean abs {m["fused_mean_abs"]:.5f} from the unfused '
            f'tp logits; prefix kernel, L=2048: mean abs '
            f'{m["prefix_mean_abs"]:.5f}; scores bf16 {m["scores_bf16"]}, '
            f'int8 weights {m["scores_int8"]}; peak {m["peak_gib"]:.2f} '
            f'GiB; {res["seconds"]:.1f} s')
        check(m['launches_forward'] == per_forward,
              f'tp forward launches {m["launches_forward"]}')
        check(m['launches_generate_bf16'] == want_gen,
              f'tp generate launches {m["launches_generate_bf16"]}')
        check(m['launches_generate_int8'] == want_gen8,
              f'tp int8-KV generate launches {m["launches_generate_int8"]}')
        check(m['launches_fused_forward'] == {
            'rmsnorm': 19, 'flash_attention': 1, 'hyena_mixer': 8},
              f'tp fused launches {m["launches_fused_forward"]}')
        check(m['launches_prefix_forward'] == {
            'rmsnorm': 19, 'fir_gate': 8, 'modal_prefix': 8,
            'flash_attention': 1},
              f'tp prefix launches {m["launches_prefix_forward"]}')
        check(m['prefix_mean_abs'] <= ref['floor9'],
              'tp forward under the prefix kernel past the yardstick')
        check(m['forward_mean_abs'] <= ref['floor9']
              and m['forward_argmax_agree'] >= 0.75,
              'tp logits moved past the one-rounding yardstick')
        check(t_b['mean_abs'] <= t_b['yardstick'] and t_b['argmax_agree']
              >= 0.75, f'tp teacher forcing, bf16 KV: {t_b}')
        check(t_8['mean_abs'] <= 4 * t_8['yardstick']
              and t_8['argmax_agree'] >= 0.75,
              f'tp teacher forcing, int8 KV: {t_8}')
        check(m['fused_mean_abs'] <= ref['floor9'],
              'tp fused forward past the yardstick')
        check(m['all_finite'] and max(abs(a - b) for a, b in zip(
            m['scores_int8'], m['scores_bf16'])) <= 0.05,
              'tp int8-weight scores past 0.05 of bf16 (phase 9\'s limit)')
        check(m['logits_equal_across_ranks']
              and m['tokens_equal_across_ranks'],
              'the ranks disagree')
    check(torch.equal(logits[0], logits[1]) and r0['part']['tokens_bf16']
          == r1['part']['tokens_bf16'] and r0['part']['tokens_int8']
          == r1['part']['tokens_int8'], 'the ranks\' results differ')
    m = r0['part']
    launches['tp2_forward_2048'] = m['launches_forward']
    launches['tp2_generate'] = m['launches_generate_bf16']
    launches['tp2_generate_int8'] = m['launches_generate_int8']
    launches['tp2_fused_forward_2048'] = m['launches_fused_forward']
    launches['tp2_prefix_forward_2048'] = m['launches_prefix_forward']
    out['b'] = dict(seconds=r0['seconds'], ranks=[r0, r1])

    # (c) the sharded train step
    t0, t1 = (x['part'] for x in rank_json('train'))
    yard = res20['first_loss_yardstick']
    want = train_launches(2, 9, 1)
    for r, t in enumerate((t0, t1)):
        log(f'   (c) rank {r}: tp = 2 train steps of 9 layers at L=2,049: '
            f'losses {t["losses"]} (phase 20\'s first {res20["losses"][0]}, '
            f'one-rounding yardstick {yard:.2e}), after {t["loss_after"]}; '
            f'steps {t["step_s"]} s; replicated masters ({t["n_replicated"]}'
            f') equal across ranks {t["replicated_equal"]}; peak '
            f'{t["peak_gib"]:.2f} GiB; launches {t["launches"]}')
        check(t['launches'] == want, f'tp train launches {t["launches"]}')
        check(abs(t['losses'][0] - res20['losses'][0]) <= yard,
              'the sharded first loss is past the one-rounding yardstick')
        check(t['loss_after'] < t['losses'][0] and all(t['replicated_equal']),
              f'sharded training: {t}')
    check(t0['losses'] == t1['losses'], 'the ranks\' losses differ')
    launches['tp2_train_2048'] = t0['launches']
    out['c'] = dict(seconds=rank_json('train')[0]['seconds'], ranks=[t0, t1])
    log(f'   phase 21 seconds: (a) {out["a"]["seconds"]:.1f} + '
        f'{out["a"]["resume_seconds"]:.1f}, (b) {out["b"]["seconds"]:.1f} '
        f'and (c) {out["c"]["seconds"]:.1f} in one launch of {secs_bc:.1f}')
    return out


def phase22_inputs(torch, evo, prompts, nudged_forward, d, model_in):
    """What phase 22's ranks are held to from the single-process
    evo-1-8k-base (seed 0), while it is on the card and unchanged: phase
    21's forward at B=1, L=2,048 and its yardstick, and greedy generation
    from phase 5's prompts, 16 tokens under the bf16 and the int8 KV cache
    (tokens, each step's logits, and the one-rounding yardstick over the
    same positions). Written to `d`/cp_in.pt, on the host."""
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.scoring import prepare_batch
    inp = torch.load(model_in)
    prompt_ids = prepare_batch(prompts, evo.tokenizer, prepend_bos=False)[0]
    P, n_new = prompt_ids.shape[1], 16
    gen = {}
    for label, kv in (('bf16', 'none'), ('int8', 'int8')):
        m = EvoModel(evo.config.replace(kv_quant=kv), evo.model.module)
        toks, steps, _ = Generator(m, evo.tokenizer, top_k=1,
                                   temperature=0.0).generate(
            input_ids=prompt_ids, num_tokens=n_new)
        full = torch.cat([torch.as_tensor(prompt_ids, device='cuda').long(),
                          toks], dim=1)
        window = slice(P - 1, P - 1 + n_new)
        floor = (nudged_forward(m, full)[:, window] - m(full)[0][:, window])
        gen[label] = dict(tokens=toks.cpu(), steps=steps.float().cpu(),
                          yardstick=float(floor.abs().mean()))
    torch.save({'ids': inp['ids'], 'logits': inp['logits'],
                'prompts': prompts, 'generate': gen},
               os.path.join(d, 'cp_in.pt'))


def phase22_context_parallel(torch, np, smi, launches, ref21, model, tok,
                             d):
    """Context parallelism: two ranks of the port on the one card over
    gloo (chosen explicitly; NCCL refuses two ranks on one card) as one
    cp = 2 mesh (`tools/cp_smoke.py model`), against the single process:
    `model` is the single-process evo-1-131k-base (seed 0), which scores
    (c)'s sequence here first. These times are gloo's host-memory
    all-to-alls and sends on one card, and say nothing of NCCL or of cp
    across cards."""
    from evo_tpu_torch.io.fasta import write_fasta
    from evo_tpu_torch.parallel.distributed import launch_local
    from evo_tpu_torch.scoring import score_sequences_segmented
    env = dict(os.environ, PYTHONPATH=ROOT)
    floor = ref21['floor']
    rng = np.random.default_rng(22)
    long_seq = ''.join(rng.choice(list('ACGT'), 16384))
    t = time.time()
    long_score = score_sequences_segmented([long_seq], model, tok,
                                           segment_len=8192)[0]
    long_single_s = time.time() - t
    path = os.path.join(d, 'cp_in.pt')
    inp = torch.load(path)
    inp.update(long_seq=long_seq, long_score=long_score)
    torch.save(inp, path)
    log(f'== 22. context parallelism ({smi}): 2 ranks on one card as one '
        f'cp = 2 mesh, torch.distributed backend gloo (passed explicitly); '
        f'the single process scores 16,384 nt with evo-1-131k-base in '
        f'segments of 8,192 in {long_single_s:.2f} s: {long_score:.6f}')

    def run(argv, tag):
        t = time.time()
        logs = launch_local(argv, 2, env=env, timeout=900,
                            log_dir=os.path.join(d, tag))
        return logs, time.time() - t

    _, secs = run(['-m', 'evo_tpu_torch.tools.cp_smoke', 'model', d],
                  'model')
    ranks = []
    for r in (0, 1):
        with open(os.path.join(d, f'model_rank{r}.json')) as f:
            ranks.append(json.load(f)['part'])
    n_new = 16
    per_forward = {'rmsnorm': 65, 'fir_gate': 29, 'flash_attention': 3}
    ring_forward = {'rmsnorm': 65, 'fir_gate': 29}
    want_gen = {'rmsnorm': 65 * n_new, 'fir_gate': 29, 'flash_attention': 3,
                'flash_attention_buffer': 3 * (n_new - 1),
                'combine_partials': 3 * (n_new - 1)}
    want_gen8 = {'rmsnorm': 65 * n_new, 'fir_gate': 29, 'flash_attention': 3,
                 'flash_attention_buffer_q8': 3 * (n_new - 1),
                 'combine_partials': 3 * (n_new - 1)}
    # 16,385 tokens with the BOS: a fresh segment of 8,193 (padded to
    # 8,194 for cp = 2) and a resumed one of 8,192
    want_long = {'rmsnorm': 65 * 2, 'fir_gate': 29 * 2, 'flash_attention': 3,
                 'flash_attention_buffer': 3}
    for r, m in enumerate(ranks):
        for key, want in (('fused', {'rmsnorm': 65, 'flash_attention': 3,
                                     'hyena_mixer': 29}),
                          ('prefix', {'rmsnorm': 65, 'fir_gate': 29,
                                      'modal_prefix': 29,
                                      'flash_attention': 3})):
            f = m['forward'].pop(key)
            log(f'   (a) rank {r}, {key} forward L=2048 (kernel '
                f'{6 if key == "fused" else 7} at C/cp = 2,048): mean abs '
                f'{f["mean_abs"]:.5f} from the Ulysses logits, argmax '
                f'agreement {f["argmax_agree"]:.4f}; launches '
                f'{f["launches"]}')
            check(f['launches'] == want,
                  f'cp {key} forward launches {f["launches"]}')
            check(f['mean_abs'] <= floor,
                  f'cp {key} forward past the yardstick')
            launches[f'cp2_{key}_forward_2048'] = f['launches']
        for mode, f in m['forward'].items():
            log(f'   (a) rank {r}, cp_attn={mode}: forward B=1 L=2048, each '
                f'cp collective between device syncs, {f["ms"]:.1f} ms, of '
                f'which the collectives {f["collectives_ms"]:.1f} ms, '
                f'{100 * f["collectives_share"]:.1f} %; against the single '
                f'process: mean abs {f["mean_abs"]:.5f} (yardstick '
                f'{floor:.5f}), max {f["max_abs"]:.4f}, argmax agreement '
                f'{f["argmax_agree"]:.4f}; launches {f["launches"]}')
            check(f['launches'] == (per_forward if mode == 'ulysses'
                                    else ring_forward),
                  f'cp {mode} forward launches {f["launches"]}')
            check(f['mean_abs'] <= floor and f['argmax_agree'] >= 0.75,
                  f'cp {mode} logits moved past the one-rounding yardstick')
            check(f['equal_across_ranks'], f'cp {mode}: the ranks differ')
        for label, want in (('bf16', want_gen), ('int8', want_gen8)):
            g = m['generate'][label]
            tf = g['teacher']
            log(f'   (b) rank {r}, {label} KV: generate 2 x 512 + {n_new} '
                f'{g["seconds"]:.2f} s; local cache k {g["cache_k_shape"]}; '
                f'tokens equal to the single process\'s '
                f'{g["tokens_equal_single"]:.4f}; teacher forcing with the '
                f'single process\'s tokens: mean abs {tf["mean_abs"]:.5f} '
                f'(yardstick {tf["yardstick"]:.5f}), argmax agreement '
                f'{tf["argmax_agree"]:.4f}; launches {g["launches"]}')
            check(g['launches'] == want,
                  f'cp {label}-KV generate launches {g["launches"]}')
            heads = g['cache_k_shape'][2 if label == 'bf16' else 1]
            check(heads == 16, f'cp {label} cache: {g["cache_k_shape"]}')
            limit = tf['yardstick'] * (1 if label == 'bf16' else 4)
            check(tf['mean_abs'] <= limit and tf['argmax_agree'] >= 0.75,
                  f'cp teacher forcing, {label} KV: {tf}')
            check(g['tokens_equal_across_ranks'],
                  f'cp {label}: the ranks\' tokens differ')
        c = m['long']
        log(f'   (c) rank {r}: evo-1-131k-base 16,384 nt in segments of '
            f'8,192: {c["score"]:.6f} in {c["seconds"]:.2f} s (single '
            f'process {long_score:.6f} in {long_single_s:.2f} s; '
            f'difference {c["diff"]:.3e}, limit 1e-2), each collective '
            f'between device syncs, of which the collectives '
            f'{c["collectives_s"]:.2f} s, {100 * c["collectives_share"]:.1f} '
            f'%; launches {c["launches"]}')
        check(c['launches'] == want_long,
              f'cp segmented launches {c["launches"]}')
        check(c['diff'] <= 1e-2 and c['score_equal_across_ranks'],
              f'cp segmented score: {c}')
        log(f'   rank {r}: 8k weights {m["weight_gib"]:.2f} GiB made in '
            f'{m["init_s"]:.1f} s; decode step B=2 '
            f'{m["generate"]["decode_step_ms"]:.2f} ms; peak '
            f'{m["peak_gib_8k"]:.2f} GiB (8k), {m["peak_gib_131k"]:.2f} GiB '
            f'(131k); parts (a) {m["forward_s"]:.1f} s, (b) '
            f'{m["generate_s"]:.1f} s, (c) {m["long_s"]:.1f} s')
    logits = [torch.load(os.path.join(d, f'cp_logits_rank{r}.pt'))
              for r in (0, 1)]
    check(torch.equal(logits[0], logits[1]) and all(
        ranks[0]['generate'][k]['tokens'] == ranks[1]['generate'][k][
            'tokens'] for k in ('bf16', 'int8')),
          'the ranks\' results differ')
    m = ranks[0]
    for mode, f in m['forward'].items():
        launches[f'cp2_forward_{mode}_2048'] = f['launches']
    launches['cp2_generate'] = m['generate']['bf16']['launches']
    launches['cp2_generate_int8'] = m['generate']['int8']['launches']
    launches['cp2_score_segmented_16k'] = m['long']['launches']

    # (d) the score CLI under --cp 2 over the first 4 sequences of phase
    # 21's FASTA, one batch
    fasta = os.path.join(d, 'four.fasta')
    write_fasta(fasta, [f's{i}' for i in range(4)], ref21['seqs'][:4])
    tsv = os.path.join(d, 'cli', 'scores.tsv')
    os.makedirs(os.path.dirname(tsv))
    _, cli_s = run(['-m', 'evo_tpu_torch.cli.score', '--cp', '2',
                    '--random-init', '--dist-backend', 'gloo',
                    '--batch-size', '4', '--input-fasta', fasta,
                    '--output-tsv', tsv], 'cli')
    with open(tsv) as f:
        rows = [ln.rstrip('\n').split('\t') for ln in f][1:]
    got = [float(x[1]) for x in rows]
    worst = max(abs(a - b) for a, b in zip(got, ref21['scores'][:4]))
    log(f'   (d) cli.score --cp 2 over {len(rows)} sequences (batch 4): '
        f'{cli_s:.1f} s; largest difference from the single-process scores '
        f'{worst:.2e} (limit 1e-2, phase 4\'s)')
    check([x[0] for x in rows] == ref21['seqs'][:4] and worst <= 1e-2
          and all(np.isfinite(got)), f'cp CLI scores {got}')
    log(f'   phase 22 seconds: ranks {secs:.1f}, CLI {cli_s:.1f}')
    return dict(seconds=secs, cli_seconds=cli_s, ranks=ranks)


def phase23_inputs(torch, np, d, corpus, spec_prompt):
    """The traffic of phase 23, written to `d`/mesh_in.json: six ragged
    requests (96-1,500 nt prompts, 16-24 new tokens, two sampled, a
    same-length pair for one batched fill, one arriving after the second
    step), two of 16 tokens under the int8 KV cache, phase 18's random
    512-nt prompt and oracle schedule, the training corpus, and (f)'s three
    requests of 24 tokens with the small bf16 model they go to (512
    channels, 4 heads of 128, 4 layers, seed 0), written as a native
    checkpoint: the kernels take bf16 only, so the CLIs' float32 `--tiny`
    does not run on the card."""
    from evo_tpu_torch import checkpoint as ckpt
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    rng = np.random.default_rng(23)
    plens = [512, 512, 96, 700, 1500, 900]
    # halved draws of 32-48: a decode step of 9 layers under tp = 2 is 18
    # gloo reduces of ~4 ms each, most of its time
    news = [int(n) // 2 for n in rng.integers(32, 49, len(plens))]
    sampled, late = (1, 4), (5,)
    requests = [dict(prompt=''.join(rng.choice(list('ACGT'), n)),
                     num_tokens=news[i],
                     temperature=1.0 if i in sampled else 0.0,
                     top_k=4 if i in sampled else 0, seed=2300 + i,
                     late=i in late) for i, n in enumerate(plens)]
    requests_int8 = [dict(prompt=''.join(rng.choice(list('ACGT'), n)),
                          num_tokens=16, temperature=0.0, top_k=0,
                          seed=2310 + i, late=False)
                     for i, n in enumerate((300, 1000))]
    cfg = tiny_config(hidden_size=512, num_filters=512, num_attention_heads=4,
                      compute_dtype='bfloat16', param_dtype='bfloat16')
    path = os.path.join(d, 'small_ckpt')
    ckpt.save_native(model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda'), path,
        cfg=cfg)
    cli = dict(path=path, num_tokens=24, prompts=[
        ''.join(rng.choice(list('ACGT'), n)) for n in (40, 96, 130)],
        flags=['--checkpoint-path', path, '--max-slots', '2', '--max-len',
               '256', '--steps-per-sync', '8', '--prompt-chunk', '64'])
    inp = dict(requests=requests, requests_int8=requests_int8,
               spec_prompt=spec_prompt, spec_schedule=[8, 8, 5, 8, 2, 0, 8, 3],
               corpus=corpus, cli=cli)
    with open(os.path.join(d, 'mesh_in.json'), 'w') as f:
        json.dump(inp, f)
    return inp


def serve_launches(calls, chunks, layers, attn, int8=False,
                   split_rows=None):
    """The launches of a server's run: each engine call of a fill (its
    length, resumed or fresh) a prefill's, and 8 decode steps a chunk,
    each with one row a slot. `split_rows`: the most query rows of the
    int8 and the bf16 buffer kernel's split key range (then the combine
    kernel runs too)."""
    hyena = layers - attn
    steps = 8 * chunks
    fresh = sum(not resumed for _, resumed in calls)
    if split_rows is None:
        from evo_tpu_torch.ops import attention_buffer
        split_rows = (attention_buffer.SPLIT_MAX_ROWS,
                      attention_buffer.SPLIT_MAX_ROWS_BF16)
    rows = split_rows[0] if int8 else split_rows[1]
    want = collections.Counter({
        'rmsnorm': (2 * layers + 1) * (steps + len(calls)),
        'fir_gate': hyena * sum(L >= 3 for L, _ in calls),
        'flash_attention': attn * fresh,
        ('flash_attention_buffer_q8' if int8 else 'flash_attention_buffer'):
            attn * (steps + len(calls) - fresh),
        'combine_partials': attn * (steps + sum(
            resumed and L <= rows for L, resumed in calls))})
    return {k: v for k, v in want.items() if v}


def truncated(model, overrides):
    """An `EvoModel` over the first `overrides['num_layers']` blocks of
    `model` (shared, not copied), with its embedding and final norm: the
    model that `random_init` with the same seed makes at that depth."""
    import copy

    from torch import nn

    from evo_tpu_torch.models import EvoModel
    module = copy.copy(model.module)
    module._modules = dict(module._modules)
    module.blocks = nn.ModuleList(
        list(model.module.blocks)[:overrides['num_layers']])
    module.config = model.module.config.replace(**overrides)
    return EvoModel(module.config, module)


def phase23_mesh(np, smi, launches, big, tok, inp, d, helpers):
    """Serving, speculation and LoRA under a mesh: two ranks of the port on
    the one card over gloo (chosen explicitly; NCCL refuses two ranks on
    one card), `tools/mesh_smoke.py model`, held to the single process:
    `big` is the single-process evo-1-8k-base (seed 0, unchanged since
    phase 4), whose first 9 layers (a) and (b) run under tp = 2 and are
    held to, and `helpers` phase 16's and 18's checks. (c)'s checks wait
    for phase 20's loss (`phase23_lora_check`). These times are gloo's
    host-memory collectives on one card, and say nothing of NCCL or of a
    mesh across cards."""
    from types import SimpleNamespace

    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.parallel.distributed import launch_local
    from evo_tpu_torch.tools.mesh_smoke import NINE
    env = dict(os.environ, PYTHONPATH=ROOT)
    log(f'== 23. serving, speculation and LoRA under a mesh ({smi}): 2 ranks '
        f'on one card, torch.distributed backend gloo (passed explicitly)')
    t = time.time()
    launch_local(['-m', 'evo_tpu_torch.tools.mesh_smoke', 'model', d], 2,
                 env=env, timeout=900, log_dir=os.path.join(d, 'model'))
    secs = time.time() - t
    ranks = []
    for r in (0, 1):
        with open(os.path.join(d, f'model_rank{r}.json')) as f:
            ranks.append(json.load(f)['part'])
    reqs = inp['requests']

    def served(part, model, requests, layers, attn, limit, label):
        """Each rank's run of `part` against the single process: token
        counts, launches, teacher forcing within `limit` yardsticks; the
        ranks' tokens and log-probs equal."""
        for r, m in enumerate(ranks):
            x = m[part]
            check(all(len(x['tokens'][i]) == q['num_tokens']
                      for i, q in enumerate(requests)),
                  f'23{label} rank {r}: a request did not end with its '
                  f'token count')
            want = serve_launches(x['calls'], len(x['chunk_ms']), layers,
                                  attn, int8='int8' in part)
            check(x['launches'] == want, f'23{label} rank {r} launches '
                  f'{x["launches"]}, expected {want}')
        x = ranks[0][part]
        results = {i: SimpleNamespace(token_ids=np.asarray(x['tokens'][i]),
                                      logps=np.asarray(x['logps'][i]))
                   for i in range(len(requests))}
        d_, dmax, f_, agree = helpers['teacher_forced'](
            model, tok, [q['prompt'] for q in requests], results,
            {i: i for i in results},
            [i for i, q in enumerate(requests) if q['temperature'] <= 0])
        check(d_ <= limit * f_ and agree >= 0.75,
              f'23{label}: served log-probs disagree with teacher forcing '
              f'({d_} against {limit} x {f_}, agreement {agree})')
        check(all(ranks[1][part][k] == x[k] for k in ('tokens', 'logps')),
              f'23{label}: the ranks\' results differ')
        for r, m in enumerate(ranks):
            y = m[part]
            log(f'   {label} rank {r}: {len(requests)} requests, '
                f'{y["new_tokens"]} new tokens in {y["seconds"]:.2f} s, '
                f'{y["tokens_per_s"]:.1f} generated tokens/s aggregate; '
                f'{len(y["chunk_ms"])} decode chunks of 8 steps, median '
                f'{y.get("chunk_median_ms", 0):.1f} ms a chunk, '
                f'{y.get("chunk_median_ms", 0) / 8:.2f} ms a step; decode '
                f'rows {y["rows"]} from slot {y["base"]}; peak '
                f'{y["peak_gib"]:.2f} GiB; launches {y["launches"]}')
        log(f'   {label}: teacher forcing against one single-process '
            f'forward: mean abs log-prob diff {d_:.5f} (max {dmax:.4f}), '
            f'one rounding step {f_:.5f} (limit {limit}x), greedy argmax '
            f'agreement {agree:.4f} (limit 0.75); ranks equal')
        return dict(mean_abs=d_, max_abs=dmax, yardstick=f_,
                    argmax_agreement=agree)

    out = {'seconds': secs}
    # (a) and (b) ran the first 9 layers of `big`: the same weights (the
    # draws of random_init run layer by layer in order) and final norm
    nine = truncated(big, NINE)
    out['a'] = served('a', nine, reqs, 9, 1, 1, '(a) tp = 2, bf16 KV')
    out['a_int8'] = served(
        'a_int8', EvoModel(nine.config.replace(kv_quant='int8'),
                         nine.module),
        inp['requests_int8'], 9, 1, 4, '(a) tp = 2, int8 KV')
    for r, m in enumerate(ranks):
        p, ts = m['a']['profiled_step'], m['a']['timed_step']
        log(f'   (a) rank {r}: one step() of 4 decoding slots in the '
            f'profiler: {p["wall_ms"]:.1f} ms, {p["collectives"]} '
            f'collectives, host reads outside them {p["host_reads"]}, '
            f'aten::_local_scalar_dense outside them {p["scalar_reads"]}, '
            f'{p["device_to_host"]} device-to-host copies in all (gloo '
            f'stages its reduces through the host); with each collective '
            f'between device syncs {ts["step_ms"]:.1f} ms, of which the '
            f'collectives {ts["collectives_ms"]:.1f} ms, '
            f'{100 * ts["collectives_share"]:.1f} %')
        check(p['host_reads'] == ['cpu'] and p['scalar_reads'] == 0,
              f'23(a) rank {r}: the chunk read the device: {p}')
        check(m['a']['rows'] == 4, f'23(a) rows {m["a"]["rows"]}')
    # (b) speculation under tp = 2
    b = ranks[0]['b']
    for r, m in enumerate(ranks):
        x = m['b']
        want = helpers['spec_launches'](x['lengths'], layers=9, attn=1)
        check(x['launches'] == want, f'23(b) rank {r} launches '
              f'{x["launches"]}, expected {want}')
        full, replays = helpers['check_schedule_ran'](
            x['lengths'], 8, SimpleNamespace(accepted=x['accepted']),
            f'23(b) rank {r}')
        log(f'   (b) rank {r}: speculation at g = 8, 32 tokens, oracle '
            f'drafter: {x["seconds"]:.2f} s without the drafter\'s '
            f'{x["oracle_seconds"]:.2f} s; accepted {x["accepted"]} of '
            f'{x["proposed"]} in {x["cycles"]} cycles, {full} accepted in '
            f'full, replays by length {dict(sorted(replays.items()))}; '
            f'launches {x["launches"]}')
    check(ranks[1]['b']['tokens'] == b['tokens']
          and ranks[1]['b']['logps'] == b['logps'],
          '23(b): the ranks\' results differ')
    d_, dmax, f_, agree = helpers['spec_teacher_forced'](
        nine, inp['spec_prompt'], np.asarray(b['tokens']), b['logps'])
    log(f'   (b): teacher forcing: mean abs log-prob diff {d_:.5f} (max '
        f'{dmax:.4f}), one rounding step {f_:.5f} (limit 1x), argmax '
        f'agreement {agree:.4f} (limit 0.75); ranks equal')
    check(d_ <= f_ and agree >= 0.75,
          '23(b): speculative log-probs disagree with teacher forcing')
    out['b'] = dict(mean_abs=d_, yardstick=f_, argmax_agreement=agree)
    # (d) dp = 2 and (e) cp = 2 on the same 9 layers
    out['d'] = served('d', nine, reqs, 9, 1, 1, '(d) dp = 2')
    for r, m in enumerate(ranks):
        check(m['d']['rows'] == 2 and m['d']['base'] == 2 * r,
              f'23(d) rank {r} decoded rows {m["d"]["rows"]} from '
              f'{m["d"]["base"]}')
    out['e'] = served('e', nine, reqs, 9, 1, 1, '(e) cp = 2')
    for r, m in enumerate(ranks):
        e = m['e']
        log(f'   (e) rank {r}: {e["steps_seen"]} decode steps\' attention, '
            f'every offset an int32 (B,) device tensor: '
            f'{e["device_offsets"]}, under an active cp axis: '
            f'{e["cp_steps"]}')
        check(e['device_offsets'] and e['cp_steps'] == e['steps_seen'] > 0,
              f'23(e) rank {r}: {e["steps_seen"]} decode steps, device '
              f'offsets {e["device_offsets"]}, {e["cp_steps"]} under cp')
    del nine
    for r, m in enumerate(ranks):
        log(f'   rank {r}: 8k weights {m["weight_gib"]:.2f} GiB made in '
            f'{m["init_s"]:.1f} s; parts (a) {m["a_s"]:.1f} s, (b) '
            f'{m["b_s"]:.1f} s, (c) {m["c_s"]:.1f} s, (d) {m["d_s"]:.1f} s, '
            f'(e) {m["e_s"]:.1f} s, (f) {m["f_s"]:.1f} s')
    a = ranks[0]
    launches['mesh_tp2_serve'] = a['a']['launches']
    launches['mesh_tp2_serve_int8'] = a['a_int8']['launches']
    launches['mesh_tp2_speculative'] = a['b']['launches']
    launches['mesh_tp2_lora_2048'] = a['c']['launches']
    launches['mesh_dp2_serve'] = a['d']['launches']
    launches['mesh_cp2_serve'] = a['e']['launches']
    out['ranks'] = ranks
    return out


def phase23_lora_check(res23, res20):
    """23 (c): LoRA under tp = 2 on phase 20's 9 layers and batch."""
    yard = res20['first_loss_yardstick']
    want = train_launches(2, 9, 1)
    for r, m in enumerate(res23['ranks']):
        c = m['c']
        log(f'   23 (c) rank {r}: LoRA rank 8 under tp = 2, 9 layers at '
            f'L = 2,049: losses {c["losses"]} (phase 20\'s first '
            f'{res20["losses"][0]}, one-rounding yardstick {yard:.2e}), '
            f'after {c["loss_after"]}; steps {c["step_s"]} s; base weights '
            f'unchanged {c["base_unchanged"]}; adapters equal across ranks '
            f'{c["adapters_equal_across_ranks"]}; peak {c["peak_gib"]:.2f} '
            f'GiB; launches {c["launches"]}')
        check(c['launches'] == want, f'23(c) launches {c["launches"]}')
        check(abs(c['losses'][0] - res20['losses'][0]) <= yard,
              '23(c): the first loss is past the one-rounding yardstick')
        check(c['loss_after'] < c['losses'][0] and c['base_unchanged']
              and c['adapters_equal_across_ranks'], f'23(c): {c}')
    check(res23['ranks'][0]['c']['losses'] == res23['ranks'][1]['c']['losses'],
          '23(c): the ranks\' losses differ')


def phase23_cli(torch, np, inp, res23, d):
    """23 (f): `cli.serve --tp 2 --dist-backend gloo` in JSONL mode under
    `launch_local`, on (f)'s small bf16 checkpoint. Rank 0's lines must be
    the lines of the same requests through a tp = 2 `GenerationServer`
    with the CLI's settings (phase 23's ranks, `mesh_smoke.cli_reference`),
    exactly. Against a one-process run of the CLI: the same ids and token
    counts; as bf16 tp rounds each rank's partial products before their
    sum, greedy streams may part at a near-tie, so the tp generations are
    held to one forward of the one-process model by (a)'s teacher-forcing
    limits, and whether the lines equal the one process's is reported."""
    from evo_tpu_torch.models import Evo
    from evo_tpu_torch.parallel.distributed import launch_local
    cli = inp['cli']
    reqs = os.path.join(d, 'requests.jsonl')
    with open(reqs, 'w') as f:
        for i, p in enumerate(cli['prompts']):
            f.write(json.dumps({'id': f'r{i}', 'num_tokens': cli['num_tokens'],
                                'prompt': p}) + '\n')
    flags = [*cli['flags'], '--requests-jsonl', reqs]
    env = dict(os.environ, PYTHONPATH=ROOT)
    # the one-process run beside the tp = 2 launch: both times are of
    # three processes sharing the card and the host
    t = time.time()
    one = subprocess.Popen([sys.executable, '-m', 'evo_tpu_torch.cli.serve',
                            *flags, '--output-jsonl',
                            os.path.join(d, 'one.jsonl')], env=env, cwd=ROOT)
    try:
        launch_local(['-m', 'evo_tpu_torch.cli.serve', '--tp', '2',
                      '--dist-backend', 'gloo', *flags, '--output-jsonl',
                      os.path.join(d, 'tp2.jsonl')], 2, env=env, timeout=600,
                     log_dir=os.path.join(d, 'cli'))
        tp_s = time.time() - t
        check(one.wait(timeout=600) == 0, '23(f): the one-process CLI failed')
        one_s = time.time() - t
    finally:
        if one.poll() is None:
            one.kill()
            one.wait()
    got, one = ([json.loads(ln) for ln in open(os.path.join(d, n))]
                for n in ('tp2.jsonl', 'one.jsonl'))
    ref = res23['ranks'][0]['f']
    check(res23['ranks'][1]['f'] == ref, '23(f): the ranks\' runs differ')
    want = [{'id': f'r{i}', 'sequence': ref['sequences'][i],
             'num_tokens': len(ref['tokens'][i]), 'score': ref['scores'][i]}
            for i in range(len(cli['prompts']))]
    check(got == want, f'23(f): cli.serve --tp 2 wrote {got}, the tp = 2 '
          f'server {want}')
    check([(g['id'], g['num_tokens']) for g in one]
          == [(w['id'], w['num_tokens']) for w in want],
          f'23(f): the one-process CLI wrote {one}')
    evo = Evo('evo-1-8k-base', 'cuda', checkpoint_path=cli['path'])
    sign = torch.randint(0, 2, (1, 1, evo.config.hidden_size), device='cuda',
                         generator=torch.Generator('cuda').manual_seed(5))
    diffs, floors, agree = [], [], []
    for p, toks, logps in zip(cli['prompts'], ref['tokens'], ref['logps']):
        full = torch.as_tensor(np.concatenate([evo.tokenizer.tokenize(p),
                                               toks]), device='cuda').long()
        P, nxt = len(p), full[len(p):]
        lp = torch.log_softmax(evo.model(full[None])[0][0, P - 1:-1].float(),
                               -1)
        hook = evo.model.module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, x, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype))
        nud = torch.log_softmax(evo.model(full[None])[0][0, P - 1:-1].float(),
                                -1)
        hook.remove()
        mine = lp.gather(-1, nxt[:, None])[:, 0]
        diffs.append((torch.as_tensor(logps, device='cuda') - mine).abs())
        floors.append((nud.gather(-1, nxt[:, None])[:, 0] - mine).abs())
        agree.append((lp.argmax(-1) == nxt).float())
    d_, f_ = float(torch.cat(diffs).mean()), float(torch.cat(floors).mean())
    agree = float(torch.cat(agree).mean())
    log(f'   (f) cli.serve --tp 2 --dist-backend gloo, JSONL, 3 requests of '
        f'{cli["num_tokens"]} tokens on a small bf16 checkpoint: {tp_s:.1f} s '
        f'(one process beside it {one_s:.1f} s); rank 0\'s lines equal the '
        f'tp = 2 '
        f'server\'s; equal to the one process\'s: {got == one}; the tp '
        f'generations against one forward of the one-process model: mean '
        f'abs log-prob diff {d_:.5f}, one rounding step {f_:.5f} (limit 1x), '
        f'greedy argmax agreement {agree:.4f} (limit 0.75)')
    check(d_ <= f_ and agree >= 0.75,
          '23(f): the tp = 2 generations disagree with the one-process model')
    return dict(seconds=tp_s, one_process_seconds=one_s,
                equal_to_one_process=got == one, mean_abs=d_, yardstick=f_,
                argmax_agreement=agree)


def cp_kernel_grads(torch, kernels, smi):
    """Kernels 1-3 under autograd at the shapes a cp = 2 rank of phase
    24's LoRA legs gives them (L = 8,192 over two ranks): kernel 1 on the
    rank's 4,096 rows; kernel 2 on the all-to-all's received buffer (1,
    8192, 3, 2048), C/cp channels over the whole L, read in place; kernel 3
    at H/cp = 16 heads over the whole L, q, k and v as views of the
    all-to-all's (1, 8192, 3, 16, 128) output. Held against the plain
    gradients under phase 19's limits and timed as phase 19 times them
    (`cp2_training` in each kernel's row)."""
    from evo_tpu_torch.ops.attention import (attention_plain,
                                             flash_attention_causal)
    from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
    from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain
    g = torch.Generator(device='cuda').manual_seed(24)

    def randn(*shape):
        return torch.randn(*shape, device='cuda', generator=g).bfloat16()
    D, C, H, Dh, L = 4096, 2048, 16, 128, 8192
    x, w = randn(L // 2, D).requires_grad_(), randn(D).requires_grad_()
    kernels['rmsnorm']['cp2_training'] = dict(
        shape='x (4096, 4096) bf16, a cp = 2 rank\'s rows of L = 8,192; '
              'grads to x and w', **time_grads(
            torch, lambda: rmsnorm(x, w), lambda: rmsnorm_plain(x, w),
            (x, w), (randn(L // 2, D),), 10))
    zl = randn(1, L, 3, C).requires_grad_()
    fw, fb, b_in = (randn(3, C, 3).requires_grad_(),
                    randn(3, C).requires_grad_(), randn(3, C).requires_grad_())

    def z():
        return zl.permute(0, 2, 3, 1)
    kernels['fir_gate']['cp2_training'] = dict(
        shape='zl (1, 8192, 3, 2048) bf16, the all-to-all\'s received '
              'buffer in place; grads to zl, taps and both biases',
        **time_grads(torch, lambda: fir_gate(z(), fw, fb, b_in=b_in),
                     lambda: fir_gate_plain(z(), fw, fb, b_in=b_in),
                     (zl, fw, fb, b_in), (randn(1, C, L), randn(1, C, L)),
                     10))
    qkv = randn(1, L, 3, H, Dh).requires_grad_()

    def qkv_views():
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kernels['flash_attention']['cp2_training'] = dict(
        shape='q, k, v (1, 8192, 16, 128) bf16 views of the all-to-all\'s '
              '(1, 8192, 3, 16, 128) output; grad to it', **time_grads(
            torch, lambda: flash_attention_causal(*qkv_views()),
            lambda: attention_plain(*qkv_views()), (qkv,),
            (randn(1, L, H, Dh),), 3))
    for name, limit in GRAD_LIMITS:
        log(f'   {name} under autograd at a cp = 2 rank\'s shapes ({smi}): '
            f'{kernels[name]["cp2_training"]}')
        check(kernels[name]['cp2_training']['grad_scaled_err'] <= limit,
              f'{name}: backward at the cp shapes disagrees with the plain '
              'gradient')
    del x, w, zl, fw, fb, b_in, qkv
    torch.cuda.empty_cache()


@contextlib.contextmanager
def contiguous_out_projection():
    """The Hyena out-projection fed a contiguous copy of its operand, as a
    cp rank feeds it (its rows come back from the all-to-all contiguous).
    At an odd L the single process hands cuBLAS the transposed view of (B,
    C, L), of leading dimension L, whose kernel for it adds in another
    order than for a contiguous operand: at L = 2,049 a third of the
    outputs round to another bf16 (none at 2,048), enough to move phase
    20's first loss by 3.9e-4. The same function, other roundings; phase
    24 holds the ranks to the single process on the ranks' operand
    layout and prints the shipped one's loss beside it."""
    from evo_tpu_torch.layers import hyena
    real = hyena._to_rows
    hyena._to_rows = lambda p, y, padded: real(p, y, padded).contiguous()
    try:
        yield
    finally:
        hyena._to_rows = real


@contextlib.contextmanager
def plain_attention_core(on):
    """With `on`, the attention layers' causal core is the plain version
    (float32 scores, softmax and P @ V, one rounding at the end), the
    arithmetic of the rings' plain float32 core, in kernel 3's place
    (which rounds P to bf16 before P @ V)."""
    from evo_tpu_torch.layers import attention
    from evo_tpu_torch.ops.attention import attention_plain
    real = attention.flash_attention_causal
    if on:
        attention.flash_attention_causal = attention_plain
    try:
        yield
    finally:
        attention.flash_attention_causal = real


def cp_train_inputs(torch, corpus, d):
    """What phase 24's ranks are held to, from the single process on the
    card, on the same weights (the first 9 layers of evo-1-8k-base, seed
    20), batches and adapters, in the ranks' arithmetic: the Hyena
    out-projection's operand laid out as a rank's
    (`contiguous_out_projection`), and for the rings' legs the plain
    float32 attention core in kernel 3's place (`plain_attention_core`;
    keys '..._plain'). For each batch: the loss and the probed gradients
    (`tools/cp_train_smoke.py`: FULL_PROBES, LORA_PROBES), the same with
    one extra bf16 rounding step (2^-8 of random sign) on the output of
    layer 0's first norm, and the time and peak of one step of each kind
    (as shipped). The probed gradients go to `d`/cp_train_ref.pt."""
    from evo_tpu_torch import lora, training
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.tools import cp_train_smoke as cts
    module = model_lib.random_init(
        cts.nine_layers(),
        torch.Generator(device='cuda').manual_seed(cts.FULL_SEED), 'cuda')
    sign = torch.randint(0, 2, (1, 1, module.config.hidden_size),
                         device='cuda',
                         generator=torch.Generator('cuda').manual_seed(5))

    def loss_and_grads(tensors, names, cfg, ids, mask, nudge):
        hook = module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype)) if nudge else None
        training.set_trainable(tensors.values(), True)
        try:
            loss = training.next_token_loss(module, cfg, ids, mask)
            loss.backward()
        finally:
            training.set_trainable(tensors.values(), False)
            if hook is not None:
                hook.remove()
        out = {n: tensors[n].grad.float().clone() for n in names}
        for t in tensors.values():
            t.grad = None
        return float(loss.detach()), out

    def reference(key, tensors, names, cfg, ids, mask):
        with contiguous_out_projection(), plain_attention_core(
                key.endswith('_plain')):
            loss, grads = loss_and_grads(tensors, names, cfg, ids, mask,
                                         False)
            nudged, moved = loss_and_grads(tensors, names, cfg, ids, mask,
                                           True)
        # one rounding step: at layer 0 (the nudge) or of the gradient
        # itself (2^-8 relative: a rank's gradient is a bf16 partial sum,
        # rounded before the float32 sum over cp), whichever moves it more
        yard = {n: max(float((moved[n] - g).norm() / g.norm()), 2.0 ** -8)
                for n, g in grads.items()}
        refs[key] = {n: g.cpu() for n, g in grads.items()}
        return dict(loss=loss, loss_yardstick=abs(nudged - loss),
                    grad_yardstick=yard)

    def one_step(make):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        make()
        torch.cuda.synchronize()
        return time.time() - t, torch.cuda.max_memory_allocated() / 2**30

    refs, res = {}, {}
    # (b) LoRA, first: the base stays as it is
    ids, mask = cts._batch(corpus, cts.LORA_SEQ_LEN)
    module.config = module.config.replace(remat=True)
    adapters = lora.init_lora(
        torch.Generator(device='cuda').manual_seed(cts.LORA_SEED), module,
        rank=8)
    lora.attach_lora(module, adapters, 16.0)
    for key in ('lora', 'lora_plain'):
        res[key] = reference(key, lora.named_adapters(adapters),
                             cts.LORA_PROBES, training.train_config(
                                 module, adapters=True), ids, mask)
    lora.detach_lora(module)
    opt = training.make_optimizer(learning_rate=1e-3)
    step = lora.make_lora_train_step(module, opt, alpha=16.0)
    res['lora']['step_s'], res['lora']['peak_gib'] = one_step(
        lambda: step(lora.init_lora_train_state(adapters, opt), ids, mask))
    del adapters, opt, step
    # (a) full fine-tuning: the ragged window under remat, then L = 2,048
    params = dict(module.named_parameters())
    for key, seq_len, remat in (('full_2049', 2048, True),
                                ('full_2048', 2047, False)):
        ids, mask = cts._batch(corpus, seq_len)
        module.config = cts.nine_layers().replace(remat=remat)
        res[key] = reference(key, params, cts.FULL_PROBES,
                             training.train_config(module), ids, mask)
    opt = training.make_optimizer(learning_rate=1e-4)
    state = training.init_train_state(module, opt)
    step = training.make_train_step(module, opt)
    res['full_2048']['step_s'], res['full_2048']['peak_gib'] = one_step(
        lambda: step(state, ids, mask))
    del module, params, opt, state, step
    torch.cuda.empty_cache()
    torch.save(refs, os.path.join(d, 'cp_train_ref.pt'))
    with open(os.path.join(d, 'cp_train_in.json'), 'w') as f:
        json.dump({'corpus': corpus}, f)
    return res


def phase24_cp_training(torch, np, smi, launches, kernels, res20, corpus,
                        d):
    """Training under context parallelism: two ranks of the port on the
    one card over gloo (chosen explicitly) as one cp = 2 mesh, through
    `tools/cp_train_smoke.py model`, held to the single process on the
    same weights and batches (`cp_train_inputs`). These times are gloo's
    all-to-alls, sends and reduces through host memory on one card, and
    say nothing of NCCL or of cp across cards."""
    from evo_tpu_torch.parallel.distributed import launch_local
    from evo_tpu_torch.tools import cp_train_smoke as cts
    t24 = time.time()
    log(f'== 24. training under context parallelism ({smi}): 2 ranks on '
        f'one card as one cp = 2 mesh, torch.distributed backend gloo '
        f'(passed explicitly)')
    cp_kernel_grads(torch, kernels, smi)
    os.makedirs(d)
    ref = cp_train_inputs(torch, corpus, d)
    ref_s = time.time() - t24
    t = time.time()
    launch_local(['-m', 'evo_tpu_torch.tools.cp_train_smoke', 'model', d], 2,
                 env=dict(os.environ, PYTHONPATH=ROOT), timeout=900,
                 log_dir=os.path.join(d, 'logs'))
    ranks_s = time.time() - t
    ranks = []
    for r in (0, 1):
        with open(os.path.join(d, f'cp_train_rank{r}.json')) as f:
            ranks.append(json.load(f))

    def expected(steps, remat, flash):
        want = (train_launches(steps, 9, 1) if remat else
                {'rmsnorm': 19 * steps, 'fir_gate': 8 * steps,
                 'flash_attention': steps})
        return {k: v for k, v in want.items()
                if v and (flash or k != 'flash_attention')}

    legs = [('full', name, key, remat, steps, attn == 'ulysses')
            for name, attn, _, remat, steps, key in cts.FULL_LEGS]
    legs += [('lora', name, key, True, steps, attn == 'ulysses')
             for name, attn, steps, key in cts.LORA_LEGS]
    for part, name, key, remat, steps, flash in legs:
        single = ref[key]
        # the single process as shipped: kernel 3, and at L = 2,049 the
        # out-projection's transposed operand (phase 20's first loss)
        as_shipped = ref[key.replace('_plain', '')]
        shipped, peak_single, step_single = (
            (res20['losses'][0], res20['peak_gib'], res20['step_median_s'])
            if key == 'full_2049' else (as_shipped['loss'],
                                        as_shipped['peak_gib'],
                                        as_shipped['step_s']))
        for r, res in enumerate(ranks):
            leg = res[part][name]
            step_ms = 1e3 * sum(leg['step_s'])
            spent = leg['collectives_ms']
            shares = {k: spent.get(k, 0.0) / step_ms
                      for k in ('forward', 'backward', 'grad_sum')}
            log(f'   24 ({"a" if part == "full" else "b"}) {name} rank {r}: '
                f'L = {leg["seq_len"]:,}{", remat" if remat else ""}: losses '
                f'{leg["losses"]} (single process in the ranks\' '
                f'arithmetic {single["loss"]}, as shipped {shipped}, '
                f'one-rounding yardstick {single["loss_yardstick"]:.2e}); s a '
                f'step {leg["step_s"]} (single process {step_single:.3f}); cp '
                f'collectives {100 * sum(shares.values()):.1f} % of the steps '
                f'(forward {100 * shares["forward"]:.1f} %, backward '
                f'{100 * shares["backward"]:.1f} %, gradient sum '
                f'{100 * shares["grad_sum"]:.1f} %); peak '
                f'{leg["peak_gib"]:.2f} GiB (single process '
                f'{peak_single:.2f}); gradients, relative distance from the '
                f'single process\'s (limit): ' + ', '.join(
                    f'{n} {leg["grad_dist"][n]:.2e} '
                    f'({single["grad_yardstick"][n]:.2e})'
                    for n in leg['grad_dist']) + f'; replicated '
                f'{"adapters" if part == "lora" else "masters"} equal across '
                f'ranks {leg["replicated_equal"]}; launches {leg["launches"]}')
            leg['shares'] = shares
            check(leg['launches'] == expected(steps, remat, flash),
                  f'24 {part} {name}: launches {leg["launches"]}, expected '
                  f'{expected(steps, remat, flash)}')
            check(abs(leg['losses'][0] - single['loss'])
                  <= single['loss_yardstick'],
                  f'24 {part} {name}: the first loss is past the '
                  'one-rounding yardstick')
            check(all(leg['grad_dist'][n] <= single['grad_yardstick'][n]
                      for n in single['grad_yardstick']),
                  f'24 {part} {name}: a gradient is past its yardstick')
            check(all(leg['replicated_equal']) and all(
                np.isfinite(leg['losses'])), f'24 {part} {name}: {leg}')
            check(steps == 1 or leg['losses'][1] < leg['losses'][0],
                  f'24 {part} {name}: the loss did not fall')
            check(part == 'full' or leg['base_unchanged'],
                  f'24 {part} {name}: LoRA moved the base weights')
        check(ranks[0][part][name]['losses'] == ranks[1][part][name]['losses'],
              f'24 {part} {name}: the ranks\' losses differ')
        phase = f'cp_train_{"" if part == "full" else "lora_"}{name}'
        launches[phase] = ranks[0][part][name]['launches']
    log(f'   phase 24 seconds: {time.time() - t24:.1f} (kernels and '
        f'single-process references {ref_s:.1f}, ranks {ranks_s:.1f}: (a) '
        f'{ranks[0]["full_seconds"]:.1f}, (b) {ranks[0]["lora_seconds"]:.1f})')
    return dict(ref=ref, ranks=ranks, seconds=time.time() - t24)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device\n')
        return 1
    if not os.path.isdir(os.path.join(ROOT, 'evo_tpu_torch')):
        sys.stderr.write('chip_smoke: run from a checkout of the repo '
                         '(evo_tpu_torch/ not found beside this script)\n')
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from evo_tpu_torch import (Evo, generate, positional_entropies,
                               positional_entropies_segmented,
                               score_sequences, score_sequences_segmented)
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.checkpoint import write_reference_snapshot
    from evo_tpu_torch.config import cli_quant_overrides, tiny_config
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.layers.attention import kv_quantize
    from evo_tpu_torch.ops.attention import (attention_plain,
                                             flash_attention_causal)
    from evo_tpu_torch.ops import attention_buffer as attention_buffer_mod
    from evo_tpu_torch.ops.attention_buffer import (attention_buffer_plain,
                                                    combine_partials,
                                                    combine_partials_plain,
                                                    flash_attention_buffer,
                                                    key_splits)
    from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
    from evo_tpu_torch.ops.hyena_mixer import (hyena_mixer, hyena_mixer_plain,
                                               hyena_mixer_supported)
    from evo_tpu_torch.ops.int4 import (int4_matmul, int4_matmul_block_plain,
                                        int4_matmul_dots8_plain,
                                        int4_matmul_plain, pack_int4,
                                        unpack_int4)
    from evo_tpu_torch.ops.mlp_gate import fused_gate, fused_gate_plain
    from evo_tpu_torch.ops.modal_prefix import (modal_prefix,
                                                modal_prefix_plain)
    from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain
    from evo_tpu_torch.quant import (int4_dot, quantize_weight_int4,
                                     quantized_bytes)
    from evo_tpu_torch.scoring import (_segment_bounds, logits_to_logprobs,
                                       prepare_batch)
    from evo_tpu_torch import serving as serving_mod
    from evo_tpu_torch.ops import int4 as int4_mod
    from evo_tpu_torch.serving import GenerationServer

    dev = torch.device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak = peaks_for(kind)
    log(f'== 1. environment: torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.device_count()} device(s); '
        f'peaks of an H100 SXM: {peak}')
    # the long conv's float32 einsums need full float32 (the JAX package
    # runs them at Precision.HIGH)
    check(not torch.backends.cuda.matmul.allow_tf32,
          'torch.backends.cuda.matmul.allow_tf32 must be False')
    check(torch.get_float32_matmul_precision() == 'highest',
          'float32 matmul precision must be "highest"')

    # -- 2. kernels -------------------------------------------------------
    t0 = time.time()
    so = _build.library_path()
    _build.library()
    build_s = time.time() - t0
    log(f'== 2. kernels built in {build_s:.1f} s: {so.name}')
    entry = None
    for line in so.with_suffix('.log').read_text().splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1] if "'" in line else None
        if 'registers' in line or 'spill' in line:
            log('   ptxas:', line.strip())
            # the split key ranges and the combine: name the kernel (and
            # its template argument, ILi<R>E)
            short = next((w for w in ('flash_buffer_bf16_split_kernel',
                                      'flash_buffer_q8_split_kernel',
                                      'combine_partials_kernel')
                          if entry and w in entry), None)
            if short and 'registers' in line:
                rest = entry.split(short)[1]
                log(f'   ptxas ({short}'
                    f'{rest[:6] if rest.startswith("ILi") else ""}):',
                    line.strip())
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    D, H, Dh = 4096, 32, 128
    kernels = {}

    # RMSNorm: the kernel and the plain version differ only in the order of
    # the fp32 row sum and in rsqrtf, so a bf16 output may round one step
    # (2^-7 relative) apart: required |err| <= 1e-2 * max(1, |value|).
    err = rel = 0.0
    for rows in (8192, 16004, 2, 1):
        x, w = randn(rows, D), randn(D)
        got, want = rmsnorm(x, w).float(), rmsnorm_plain(x, w).float()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        r = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        log(f'   rmsnorm rows={rows}: max abs err {e:.3e}, scaled {r:.3e}')
        err, rel = max(err, e), max(rel, r)
    check(rel <= 1e-2, f'rmsnorm kernel disagrees: {rel}')
    x, w = randn(8192, D), randn(D)
    nbytes = 2 * x.numel() * 2 + D * 2
    kernels['rmsnorm'] = dict(
        name='rmsnorm', route='cuda', source='evo_tpu_torch/csrc/rmsnorm.cu',
        replaces='evo_tpu/ops/pallas_rmsnorm.py:21', max_abs_err=err,
        ms=time_ms(torch, lambda: rmsnorm(x, w)),
        plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w)),
        bound_ms=1e3 * max(nbytes / peak['bytes_s'],
                           4 * x.numel() / peak['fp32']),
        bound_by='bytes',
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (D,), w, 1e-6)),
        shape='x (8192, 4096) bf16')

    # FIR + gate on the in-projection's (B, L, 3, C) output read in place,
    # with the in-projection bias folded in: the kernel repeats the plain
    # version's arithmetic in the same order without FMA contraction, so
    # outputs must be bitwise equal. The same with the carried tail of a
    # resumed segment in the place of the zeros before t=0, against
    # `fir_causal_conv(state=)` + gate.
    err, worst_equal = 0.0, 1.0
    for B, L in ((1, 1), (1, 3), (1, 77), (2, 1000), (1, 1000), (1, 8192)):
        zl, fw, fb, b_in = (randn(B, L, 3, D), randn(3, D, 3), randn(3, D),
                            randn(3, D))
        z = zl.permute(0, 2, 3, 1)
        for tail in (None, randn(B, 3, D, 2)):
            for got, want in zip(fir_gate(z, fw, fb, tail, b_in=b_in),
                                 fir_gate_plain(z, fw, fb, tail, b_in=b_in)):
                torch.cuda.synchronize()
                e = float((got.float() - want.float()).abs().max())
                eq = float((got == want).float().mean())
                err, worst_equal = max(err, e), min(worst_equal, eq)
            log(f'   fir_gate B={B} L={L} tail={tail is not None}: max abs '
                f'err {e:.3e}, equal {eq:.6f}')
    check(err == 0 and worst_equal == 1.0,
          f'fir_gate kernel disagrees: err {err}, equal {worst_equal}')
    zl, fw, fb, b_in = randn(1, 8192, 3, D), randn(3, D, 3), randn(3, D), \
        randn(3, D)
    z = zl.permute(0, 2, 3, 1)
    n_in = zl.numel()
    # each input read once (zl, taps, both biases), each output written once
    nbytes = (n_in + 2 * n_in // 3 + fw.numel() + fb.numel()
              + b_in.numel()) * 2
    # six buffers of 201 MB in turns: each launch finds its input cold
    zls = [zl] + [randn(1, 8192, 3, D) for _ in range(5)]
    kernels['fir_gate'] = dict(
        name='fir_gate', route='cuda', source='evo_tpu_torch/csrc/fir_gate.cu',
        replaces='evo_tpu/ops/pallas_fir.py:28', max_abs_err=err,
        bit_equal_fraction=worst_equal,
        ms=time_graph_ms(torch, [
            (lambda zz: lambda: fir_gate(zz.permute(0, 2, 3, 1), fw, fb,
                                         b_in=b_in))(zz) for zz in zls]),
        time_ms=time_ms(torch, lambda: fir_gate(z, fw, fb, b_in=b_in)),
        plain_ms=time_ms(torch, lambda: fir_gate_plain(z, fw, fb,
                                                       b_in=b_in)),
        # per (b, c, t): the bias add, 3 streams x (3 mul + 3 add + bias)
        # and the gate
        bound_ms=1e3 * max(nbytes / peak['bytes_s'],
                           25 * (n_in // 3) / peak['fp32']),
        bound_by='bytes', library_ms=None,
        # what the layer no longer runs before the kernel: the bias pass
        # and the (B, L, 3, C) -> (B, 3, C, L) copy
        route_before_ms=time_ms(
            torch, lambda: (zl + b_in).permute(0, 2, 3, 1).contiguous()),
        shape='zl (1, 8192, 3, 4096) bf16 with b_in')
    del zls

    # Causal flash attention. The kernel rounds P to bf16 before P @ V (as
    # the TPU kernel does) where the plain version keeps float32, and both
    # round their output to bf16. An output row is a convex mixture of rows
    # of v, so its size falls along the sequence (about sqrt(e / (i + 1))
    # at row i for these inputs) and no one absolute limit holds the late
    # rows. Each error is scaled instead by the larger of |want| and the
    # rms of its (position, head) row: the output rounding gives at most
    # one bf16 step (2^-7) of that, P's rounding a few 2^-9. Required:
    # scaled error <= 2^-5 (four bf16 steps), which a kernel off by 5 %
    # fails. The second half of the rows at L=8192, whose long chains of
    # key tiles and rescales only that shape reaches, is reported apart.
    err = scaled = 0.0
    # (2, 127 to 129) and (2, 4097): the edges of the 128-row query tile
    # and of the TMA boxes; L=8192 last, for `late`
    for B, L in ((1, 1), (1, 63), (2, 127), (2, 128), (2, 129), (2, 1000),
                 (2, 4097), (1, 8192)):
        qkv = randn(B, L, 3, H, Dh)       # strided views, as the model has
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        got, want = flash_attention_causal(q, k, v), attention_plain(q, k, v)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        r = scaled_err(got, want)
        late = scaled_err(got[:, L // 2:], want[:, L // 2:])
        log(f'   flash_attention B={B} L={L}: max abs err {e:.3e}, scaled '
            f'{r:.3e}, scaled over rows >= {L // 2} {late:.3e}')
        err, scaled = max(err, e), max(scaled, r)
        del qkv, q, k, v, got, want
    check(scaled <= 2 ** -5, f'flash attention kernel disagrees: {scaled}')
    L = 8192
    qkv = randn(1, L, 3, H, Dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = attention_flops(H, Dh, L, [0])
    kernels['flash_attention'] = dict(
        name='flash_attention', route='cuda',
        source='evo_tpu_torch/csrc/flash_attention.cu',
        replaces='evo_tpu/ops/pallas_attention.py:28', max_abs_err=err,
        max_scaled_err=scaled, max_scaled_err_late_rows=late,
        ms=time_ms(torch, lambda: flash_attention_causal(q, k, v), reps=10),
        plain_ms=time_ms(torch, lambda: attention_plain(q, k, v), reps=3,
                         warmup=1),
        bound_ms=1e3 * max(4 * L * H * Dh * 2 / peak['bytes_s'],
                           flops / peak['bf16']),
        bound_by='operations',
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=10),
        shape='q, k, v (1, 8192, 32, 128) bf16 views of one QKV tensor')
    # Attention over a KV buffer, bf16 and int8. Both kernels repeat the
    # causal kernel's arithmetic (bf16 P before P @ V, bf16 output) with
    # the key range and the mask taken from the offset, so they are held
    # to the same limit for the same reasons: scaled error <= 2^-5. The
    # int8 kernel is held against the plain version on the same codes and
    # scales; both dequantise as bf16(float(code) * scale), so nothing of
    # the quantisation itself enters the comparison. The buffers' tails
    # past the last query are finite garbage (x10) that the mask must
    # keep out; zeros there would hide a wrong mask.
    def buffers(B, Lq, T, offset, heads=H, gen=None):
        rn = randn if gen is None else (lambda *shape: torch.randn(
            *shape, device=dev, generator=gen).bfloat16())
        q, kb, vb = (rn(B, Lq, heads, Dh), rn(B, T, heads, Dh),
                     rn(B, T, heads, Dh))
        offs = [offset] * B if isinstance(offset, int) else offset
        for b, o in enumerate(offs):
            kb[b, o + Lq:] *= 10
            vb[b, o + Lq:] *= 10
        off = offset if isinstance(offset, int) else torch.tensor(
            offset, dtype=torch.int32, device=dev)
        (kq, ks), (vq, vs) = kv_quantize(kb), kv_quantize(vb)
        q8 = tuple(t.transpose(1, 2).contiguous() for t in (kq, vq, ks, vs))
        return q, off, (kb, vb), (q8[0], q8[1]), (q8[2], q8[3])

    err4 = err5 = scaled4 = scaled5 = 0.0
    for B, Lq, T, offset in (
            (1, 128, 1024, 0), (1, 128, 1024, 128), (1, 128, 1024, 731),
            (1, 100, 1024, 512), (1, 256, 2048, 1792),
            (2, 64, 1000, (100, 900)),       # two offsets, T % 128 != 0
            (2, 1, 777, (5, 776)),           # decode: one query row
            # the edges of the 128-row query tile and the key tiles
            (1, 129, 1024, 127), (1, 129, 1024, 128),
            (2, 129, 1000, (60, 300)),       # rows that cross a key tile
            (2, 200, 1100, (127, 900)),      # keys end inside a tile
            (1, 1, 1000, 999),               # one row at the last slot
            # int8: the split key range at one query row, the two regimes
            (2, 1, 65536, (5, 60000)),       # splits past row 0's prefix
            (1, 1, 4096, 4095),              # the prefix ends on a split edge
            (1, 4, 3000, 2000), (1, 5, 3000, 2000),
            (1, 8192, 131072, 122880)):      # a late segment of a 131k run
        q, off, bf, i8, sc = buffers(B, Lq, T, offset)
        got = flash_attention_buffer(q, *bf, off)
        got8 = flash_attention_buffer(q, *i8, off, *sc)
        torch.cuda.synchronize()
        want = attention_buffer_plain(q, *bf, off)
        want8 = attention_buffer_plain(q, *i8, off, *sc)
        e4 = float((got.float() - want.float()).abs().max())
        e5 = float((got8.float() - want8.float()).abs().max())
        r4, r5 = scaled_err(got, want), scaled_err(got8, want8)
        log(f'   flash_attention_buffer B={B} Lq={Lq} T={T} offset={offset}:'
            f' bf16 max abs err {e4:.3e}, scaled {r4:.3e}; int8 max abs err '
            f'{e5:.3e}, scaled {r5:.3e}; int8 against bf16 buffers, scaled '
            f'{scaled_err(got8, got):.3e}')
        err4, err5 = max(err4, e4), max(err5, e5)
        scaled4, scaled5 = max(scaled4, r4), max(scaled5, r5)
        del got, got8, want
    check(scaled4 <= 2 ** -5, f'bf16 buffer kernel disagrees: {scaled4}')
    check(scaled5 <= 2 ** -5, f'int8 buffer kernel disagrees: {scaled5}')

    # Kernel 4 at 1-16 query rows runs its split key range (mma.sync) and
    # the combine kernel: more shapes of that regime (2-16 rows, per-row
    # offsets near 0 and near T, T % 64 != 0) and the strided 16-head
    # views of a tp = 2 rank under the Ulysses all-to-all, each within the
    # same limit and the same bits on a second run. These draw from a
    # generator of their own: `g`'s stream, and with it every later
    # phase's inputs and the yardstick's random signs, stays as it was.
    g21 = torch.Generator(device=dev).manual_seed(21)

    def randn21(*shape):
        return torch.randn(*shape, device=dev, generator=g21).bfloat16()

    split4 = dict(max_abs_err=0.0, max_scaled_err=0.0, bit_equal=True)
    split_cases = [(1, 2, 3000, 2000), (1, 8, 3000, 2000),
                   (1, 9, 8100, 8000), (1, 16, 3000, 2000),
                   (1, 16, 1000, 0), (2, 16, 1000, (100, 984)),
                   (4, 9, 2048, (0, 17, 1919, 2039)),
                   (2, 1, 1024, (512, 530), 'strided'),
                   (2, 9, 1024, (100, 900), 'strided')]
    for case in split_cases:
        B, Lq, T, offset = case[:4]
        if len(case) > 4:
            qs = randn21(B, Lq, H, Dh)[:, :, H // 2:]
            bfs = tuple(randn21(B, T, H, Dh)[:, :, :H // 2] for _ in (0, 1))
            offs = torch.tensor(offset, dtype=torch.int32, device=dev)
        else:
            # (the last case's q, bf, i8 and sc above stay for the times)
            qs, offs, bfs, _, _ = buffers(B, Lq, T, offset, gen=g21)
        got = flash_attention_buffer(qs, *bfs, offs)
        again = flash_attention_buffer(qs, *bfs, offs)
        torch.cuda.synchronize()
        want = attention_buffer_plain(qs, *bfs, offs)
        e, r = float((got.float() - want.float()).abs().max()), scaled_err(
            got, want)
        split4['max_abs_err'] = max(split4['max_abs_err'], e)
        split4['max_scaled_err'] = max(split4['max_scaled_err'], r)
        split4['bit_equal'] &= torch.equal(got, again)
        log(f'   flash_attention_buffer (bf16 split) {case}: max abs err '
            f'{e:.3e}, scaled {r:.3e}, bit-equal on a rerun '
            f'{torch.equal(got, again)}')
        del qs, offs, bfs, got, again, want
    check(split4['max_scaled_err'] <= 2 ** -5 and split4['bit_equal'],
          f'bf16 split key range disagrees: {split4}')

    # Times at the shapes of a 131k run: the last prefill segment (q, bf,
    # i8 and sc are still that case) and one decode step over the 122,880
    # positions before it.
    B, Lq, T, offset = 1, 8192, 131072, 122880
    live = offset + Lq
    flops = attention_flops(H, Dh, Lq, [offset])
    qo_bytes = 2 * Lq * H * Dh * 2
    row = torch.arange(Lq, device=dev)[:, None]
    mask = torch.arange(T, device=dev)[None, :] <= offset + row
    qt, kt, vt = (t.transpose(1, 2) for t in (q, *bf))
    q1 = randn(1, 1, H, Dh)
    kernels['flash_attention_buffer'] = dict(
        name='flash_attention_buffer', route='cuda',
        source='evo_tpu_torch/csrc/flash_attention_buffer.cu',
        replaces='evo_tpu/ops/pallas_attention.py:111', max_abs_err=err4,
        max_scaled_err=scaled4,
        ms=time_ms(torch, lambda: flash_attention_buffer(q, *bf, offset),
                   reps=3, warmup=1),
        plain_ms=time_ms(torch, lambda: attention_buffer_plain(
            q, *bf, offset), reps=1, warmup=0),
        bound_ms=1e3 * max((qo_bytes + 2 * live * H * Dh * 2)
                           / peak['bytes_s'], flops / peak['bf16']),
        bound_by='operations',
        library_ms=time_ms(torch, lambda: sdpa_over_live_prefix(
            q, *bf, offset), reps=3, warmup=1),
        library_mask_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps=3, warmup=1),
        decode_ms=time_ms(torch, lambda: flash_attention_buffer(
            q1, *bf, offset - 1), reps=5, warmup=1),
        # one query row at offset 122,879 reads the live 122,880 positions
        decode_bound_ms=1e3 * max(
            (2 * offset * H * Dh * 2 + 2 * H * Dh * 2) / peak['bytes_s'],
            attention_flops(H, Dh, 1, [offset - 1]) / peak['bf16']),
        decode_library_ms=time_ms(torch, lambda: sdpa_over_live_prefix(
            q1, *bf, offset - 1), reps=5, warmup=1),
        shape='q (1, 8192, 32, 128) at offset 122,880, bf16 buffers '
              '(1, 131072, 32, 128); library: SDPA with the lower-right '
              'causal bias over the live prefix (library_mask_ms: SDPA with '
              'a dense boolean mask over the whole buffer); decode: q (1, 1, '
              '32, 128) at offset 122,879, SDPA over the live prefix beside '
              'it; by_offset: one row at three offsets; regimes: 1-16 rows at '
              'the end of the buffer and at offset 8,000 in each regime; '
              'split: the split regime\'s checks; by graph replay')

    # kernel 4 at few rows: one row over three live prefixes beside SDPA
    # over the same prefix, and both regimes at 1 to 16 rows at the end of
    # the 131k buffer and at offset 8,000 (a g = 8 verify pass), by graph
    # replay; every live prefix here is over 120 MB, beyond the L2
    def k4_bound_ms(o, rows=1):
        return 1e3 * max((2 * (o + rows) + 2 * rows) * H * Dh * 2
                         / peak['bytes_s'],
                         attention_flops(H, Dh, rows, [o]) / peak['bf16'])

    by_offset4 = {}
    for o in (8191, 65535, 122879):
        by_offset4[o] = dict(
            ms=time_graph_ms(torch, [lambda: flash_attention_buffer(
                q1, *bf, o)]),
            library_ms=graph_or_events_ms(torch, [
                lambda: sdpa_over_live_prefix(q1, *bf, o)]),
            bound_ms=k4_bound_ms(o))
    regimes4 = {}
    split_rows4 = attention_buffer_mod.SPLIT_MAX_ROWS_BF16
    for at_end in (True, False):
        for rows in (1, 2, 4, 8, 9, 16):
            o = T - rows if at_end else 8000
            qr = randn21(1, rows, H, Dh)
            entry = dict(bound_ms=k4_bound_ms(o, rows))
            if rows <= split_rows4:
                entry['split_ms'] = time_graph_ms(
                    torch, [lambda: flash_attention_buffer(qr, *bf, o)])
            attention_buffer_mod.SPLIT_MAX_ROWS_BF16 = 0
            try:
                entry['mainloop_ms'] = time_graph_ms(
                    torch, [lambda: flash_attention_buffer(qr, *bf, o)])
            finally:
                attention_buffer_mod.SPLIT_MAX_ROWS_BF16 = split_rows4
            if rows in (1, 4, 9):
                entry['library_ms'] = graph_or_events_ms(torch, [
                    lambda: sdpa_over_live_prefix(qr, *bf, o)])
            regimes4[f'rows={rows} offset={o}'] = entry
    log(f'   flash_attention_buffer (bf16) at one query row by offset: '
        f'{by_offset4}; by regime: {regimes4}')
    kernels['flash_attention_buffer'].update(
        by_offset=by_offset4, regimes=regimes4, split=split4,
        split_max_rows=split_rows4)
    # every code and scale of the live prefix is read once
    def kv8_bytes(n):
        return 2 * H * n * (Dh + 4)

    def decode8_bound_ms(o, rows=1):
        return 1e3 * max((kv8_bytes(o + rows) + 2 * rows * H * Dh * 2)
                         / peak['bytes_s'],
                         attention_flops(H, Dh, rows, [o]) / peak['bf16'])

    # kernel 5 at one query row over three live prefixes (the split key
    # range and the combine kernel; by graph replay also with a (1,)
    # device offset beside the int one: the split's count follows the
    # buffer then, each block's range the offset on the device), and both
    # of its regimes at 1 to 8 rows at the end of the 131k buffer, the
    # split one where it is built
    by_offset5 = {}
    for o in (8191, 65535, 122879):
        dev_off = torch.full((1,), o, dtype=torch.int32, device=dev)
        by_offset5[o] = dict(
            ms=time_ms(torch, lambda: flash_attention_buffer(
                q1, *i8, o, *sc), reps=10, warmup=2),
            bound_ms=decode8_bound_ms(o),
            graph_ms_int_offset=time_graph_ms(torch, [
                lambda: flash_attention_buffer(q1, *i8, o, *sc)]),
            graph_ms_device_offset=time_graph_ms(torch, [
                lambda: flash_attention_buffer(q1, *i8, dev_off, *sc)]))
    ratio5 = (by_offset5[8191]['graph_ms_device_offset']
              / by_offset5[8191]['graph_ms_int_offset'])
    check(ratio5 <= 1.3, f'kernel 5 with a device offset at 8,191 live of '
          f'131,072 takes {ratio5:.2f}x the int offset\'s time')
    regimes5 = {}
    split_rows = attention_buffer_mod.SPLIT_MAX_ROWS
    for rows in (1, 2, 4, 8):
        qr, o = randn(1, rows, H, Dh), offset - rows
        entry = dict(bound_ms=decode8_bound_ms(o, rows))
        if rows <= split_rows:
            entry['split_ms'] = time_ms(torch, lambda: flash_attention_buffer(
                qr, *i8, o, *sc), reps=10, warmup=2)
        attention_buffer_mod.SPLIT_MAX_ROWS = 0
        try:
            entry['wgmma_ms'] = time_ms(torch, lambda: flash_attention_buffer(
                qr, *i8, o, *sc), reps=5, warmup=1)
        finally:
            attention_buffer_mod.SPLIT_MAX_ROWS = split_rows
        regimes5[rows] = entry
    log(f'   flash_attention_buffer_q8 at one query row by offset: '
        f'{by_offset5}; by regime at offset {offset} - rows: {regimes5}')
    kernels['flash_attention_buffer_q8'] = dict(
        name='flash_attention_buffer_q8', route='cuda',
        source='evo_tpu_torch/csrc/flash_attention_buffer.cu',
        replaces='evo_tpu/ops/pallas_attention.py:169', max_abs_err=err5,
        max_scaled_err=scaled5, **by_offset5[122879],
        plain_ms=time_ms(torch, lambda: attention_buffer_plain(
            q1, *i8, offset - 1, *sc), reps=1, warmup=0),
        bound_by='bytes', library_ms=None, by_offset=by_offset5,
        regimes=regimes5,
        prefill_ms=time_ms(torch, lambda: flash_attention_buffer(
            q, *i8, offset, *sc), reps=3, warmup=1),
        prefill_bound_ms=1e3 * max(
            (qo_bytes + kv8_bytes(live)) / peak['bytes_s'],
            flops / peak['bf16']),
        shape='q (1, 1, 32, 128) at offset 122,879 (decode: the split key '
              'range and the combine kernel; by_offset at 8,191, 65,535 and '
              '122,879), int8 buffers (1, 32, 131072, 128), scales (1, 32, '
              '131072); prefill_ms: q (1, 8192, 32, 128) at offset 122,880; '
              'regimes: rows 1 to 8 at offset 122,880 - rows, each regime')

    # The combine kernel merges a decode step's partials in a fixed order:
    # against its plain twin within one bf16 rounding of the output (2^-7
    # of the larger of the value and its row's rms), and the same bits
    # twice. Partials as the split kernel leaves them at offset 122,879,
    # some empty.
    chunk5, S5 = key_splits(offset, H, torch.cuda.get_device_properties(
        0).multi_processor_count)
    pm = torch.randn(1, H, 1, S5, device=dev, generator=g) * 4
    pm[..., S5 // 2:] = float('-inf')
    pl = torch.rand(1, H, 1, S5, device=dev, generator=g) * 50 + 1
    pl[torch.isinf(pm)] = 0
    pacc = torch.randn(1, H, 1, S5, Dh, device=dev, generator=g) * 10
    pacc[torch.isinf(pm)] = 0
    got = combine_partials(pm, pl, pacc)
    again = combine_partials(pm, pl, pacc)
    torch.cuda.synchronize()
    want = combine_partials_plain(pm, pl, pacc)
    r = scaled_err(got, want)
    log(f'   combine_partials S={S5} (chunk {chunk5}): scaled err {r:.3e}, '
        f'bit-equal on a second run {torch.equal(got, again)}')
    check(r <= 2 ** -7 and torch.equal(got, again),
          f'combine kernel disagrees: {r}')
    kernels['combine_partials'] = dict(
        name='combine_partials', route='cuda',
        source='evo_tpu_torch/csrc/flash_attention_buffer.cu',
        replaces='evo_tpu/ops/pallas_attention.py:169',
        max_abs_err=float((got.float() - want.float()).abs().max()),
        max_scaled_err=r,
        ms=time_graph_ms(torch, [lambda: combine_partials(pm, pl, pacc)]),
        ms_by_events=time_ms(torch, lambda: combine_partials(pm, pl, pacc)),
        plain_ms=time_ms(torch, lambda: combine_partials_plain(pm, pl, pacc)),
        bound_ms=1e3 * (pacc.numel() + 2 * pm.numel()) * 4 / peak['bytes_s'],
        bound_by='bytes', library_ms=None,
        shape=f'partials of a decode step at offset 122,879: m, l (1, 32, '
              f'1, {S5}), acc (1, 32, 1, {S5}, 128) fp32 -> (1, 1, 32, 128) '
              f'bf16 (part of kernel 5\'s function; ms replayed from a CUDA '
              f'graph, the kernel being shorter than a launch)')
    del pm, pl, pacc, got, again, want
    del off, bf, i8, sc, mask, row, q1, want8

    # Weight-only int4 matmul. The kernel multiplies the same bf16 values
    # as the plain version (bf16 x int4 is exact in float32) and differs
    # only in the order of the float32 sums inside a group of 128 (FMAs
    # down the rows at up to 2 rows of x, wgmma above) and in the order in
    # which the groups' scaled sums are added (split by split, or block by
    # block): up to 11,008 terms at float32 epsilon.
    # Required |err| <= 1e-4 of the larger of |want| and its row's rms; x
    # of K <= Kp columns (the kernel reads zeros past K); the bf16 output
    # the float32 one rounded once, bit for bit; and a second run
    # bit-equal to the first.
    def int4_case(M, Kp, N, gen=None):
        gen = g if gen is None else gen
        x = torch.randn(M, Kp, device=dev, generator=gen).bfloat16()
        q = torch.randint(-8, 8, (Kp, N), device=dev, generator=gen,
                          dtype=torch.int8)
        s = torch.rand(Kp // 128, N, device=dev, generator=gen) * 0.09 + 0.01
        return x, pack_int4(q), s

    # Kernel 8's cases beyond those of the earlier runs draw from a
    # generator of their own: `g`'s stream, and with it every later phase's
    # inputs and the yardstick's random signs (phase 5), stays as it was
    g8 = torch.Generator(device=dev).manual_seed(8)
    earlier_rows = (1, 2, 4, 7, 8, 128)

    # (K, Kp, N): w1 / w2, w3 (K padded to Kp), w_in / wqkv, w_out
    layer_calls = ((4096, 4096, 10928), (10928, 11008, 4096),
                   (4096, 4096, 12288), (4096, 4096, 4096))
    err8 = scaled8 = 0.0
    for M, K, Kp, N in (
            [(8, 256, 256, 512), (1, 4096, 4096, 688), (16, 1536, 1536, 512),
             (128, 512, 512, 1024), (5, 500, 512, 1001), (3, 130, 256, 40)]
            + [(M, K, Kp, N) for K, Kp, N in layer_calls
               for M in (1, 2, 5, 7, 8, 9, 16, 32, 64, 128)]):
        x, packed, sc = int4_case(
            M, Kp, N, None if M in earlier_rows or Kp < 4096 else g8)
        x = x[:, :K].contiguous()
        got = int4_matmul(x, packed, sc)
        got16 = int4_matmul(x, packed, sc, torch.bfloat16)
        again = int4_matmul(x, packed, sc)
        torch.cuda.synchronize()
        want = int4_matmul_plain(x, packed, sc)
        e, r = float((got - want).abs().max()), scaled_err(got, want)
        log(f'   int4_matmul M={M} K={K} Kp={Kp} N={N}: max abs err '
            f'{e:.3e}, scaled {r:.3e}')
        check(torch.equal(got, again), 'int4_matmul differs run to run')
        check(torch.equal(got16, got.bfloat16()),
              'int4_matmul bf16 output is not the float32 one rounded')
        err8, scaled8 = max(err8, e), max(scaled8, r)
    # K = 128 padded to Kp = 256 (the shape class of wo): zero rows
    # interleave with real ones across the two nibbles, against the exact
    # product with the dequantized weight
    w = randn(2, 64, 384).float() * 0.05
    x = randn(3, 2, 64)
    qw = quantize_weight_int4(w, 2)
    got = int4_dot(x, qw, nc=2).float()
    want = int4_dot(x.cpu(), qw.cpu(), nc=2).float().to(dev)
    r = scaled_err(got, want)
    log(f'   int4_dot nc=2, K=128 padded to 256: scaled err {r:.3e} against '
        f'the plain version on the CPU (bf16 outputs: limit 2^-7)')
    check(scaled8 <= 1e-4 and r <= 2 ** -7,
          f'int4 kernel disagrees: {scaled8}, padded {r}')

    # Times as a decode step calls the kernel: x of K columns in bf16, y in
    # bf16. A decode step reads each weight once, so the kernel finds it
    # cold: enough weights (past the 50 MB L2) taken in turns, replayed
    # from a CUDA graph, because the kernel is shorter than a launch from
    # the host takes. `ms_by_events` is the event time around one call,
    # wrapper included. `library_ms`: `torch._weight_int4pack_mm`
    # (tinygemm) on the same int4 values and group-128 scales, repacked
    # into its layout (uint8 (N, Kp/2) of q = v + 8, even k in the high
    # nibble; bf16 scales with zero points 0): bf16 scales and output, so
    # another rounding of the same function; its scaled error is logged as
    # a yardstick only. The port never calls it.
    def int4_bound_ms(M, K, Kp, N):
        nbytes = Kp // 2 * N + (Kp // 128) * N * 4 + M * K * 2 + M * N * 2
        return 1e3 * max(nbytes / peak['bytes_s'],
                         2 * M * K * N / peak['bf16'])

    def tinygemm(packed, sc):
        q = (unpack_int4(packed).to(torch.int32) + 8).t().contiguous()
        w4 = torch._convert_weight_to_int4pack(
            ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8), 8)
        return w4, torch.stack([sc.bfloat16(), torch.zeros_like(
            sc).bfloat16()], -1).contiguous()

    def int4_times(M, K, Kp, N, plain=False, gen=None):
        ws = [int4_case(M, Kp, N, gen)
              for _ in range(int(110e6 // (Kp // 2 * N)) + 1)]
        ws = [(x[:, :K].contiguous(), p, s) for x, p, s in ws]
        fns = [(lambda c=c: int4_matmul(*c, torch.bfloat16)) for c in ws]
        out = dict(ms=time_graph_ms(torch, fns),
                   ms_by_events=time_ms(torch, fns[0]),
                   bound_ms=int4_bound_ms(M, K, Kp, N))
        if plain:
            out['plain_ms'] = time_ms(torch, lambda: int4_matmul_plain(
                *ws[0], torch.bfloat16), reps=3, warmup=1)
        try:
            tg = [tinygemm(p, s) for _x, p, s in ws]
            xs = [F.pad(x, (0, Kp - K)) for x, _p, _s in ws]
            out['library_ms'] = time_graph_ms(torch, [
                (lambda xx=xx, t=t: torch._weight_int4pack_mm(xx, t[0], 128,
                                                               t[1]))
                for xx, t in zip(xs, tg)])
            out['library_scaled_err'] = scaled_err(
                torch._weight_int4pack_mm(xs[0], tg[0][0], 128, tg[0][1]),
                int4_matmul_plain(*ws[0]))
        except (RuntimeError, NotImplementedError) as exc:
            # the yardstick only: say why it is missing
            out['library_ms'] = None
            out['library_error'] = f'{type(exc).__name__}: {exc}'[:200]
        del ws, fns
        return out

    by_rows = {M: int4_times(M, 4096, 4096, 12288, plain=M in (1, 8, 128),
                             gen=None if M in earlier_rows else g8)
               for M in (1, 2, 4, 5, 8, 9, 16, 32, 64, 128)}
    per_layer = {f'{K}x{N}': int4_times(2, K, Kp, N)
                 for K, Kp, N in layer_calls}
    per_layer_rows = {f'{K}x{N}/M={M}': int4_times(M, K, Kp, N, gen=g8)
                      for K, Kp, N in layer_calls for M in (8, 128)}
    kernels['int4_matmul'] = dict(
        name='int4_matmul', route='cuda',
        source='evo_tpu_torch/csrc/int4_matmul.cu',
        replaces='evo_tpu/ops/pallas_int4.py:87', max_abs_err=err8,
        max_scaled_err=scaled8, **by_rows[1], bound_by='bytes',
        design='M <= 2: streaming (float32 FMAs, cp.async); M = 3-128: '
               'wgmma, weights dequantized in registers into its A '
               'fragments, TMA ring, stream-K blocks',
        by_rows=by_rows, by_call_at_2_rows=per_layer,
        by_call_at_8_and_128_rows=per_layer_rows,
        shape='x (1, 4096) bf16, packed (2048, 12288) int8, scales '
              '(32, 12288) fp32 -> y bf16 (decode, M = 1; by_rows: M = 1, 2, '
              '4, 5, 8, 9, 16, 32, 64, 128; by_call_at_2_rows, '
              'by_call_at_8_and_128_rows: each weight of a layer); '
              'library: torch._weight_int4pack_mm')
    log(f'   int4_matmul by rows at 4096 x 12288: {by_rows}; by call of '
        f'a layer at M=2: {per_layer}; at M=8 and 128: {per_layer_rows}')
    del qw
    phase2_launches = int4_mode_checks(
        torch, log, kernels, peak, int4_case, layer_calls, tinygemm,
        int4_matmul, int4_matmul_plain, int4_matmul_block_plain,
        int4_matmul_dots8_plain)

    # The fused Hyena mixer on the in-projection's (B, L, 3, C) output read
    # in place, with the in-projection bias folded in. Its bias add and FIR
    # repeat the plain version's arithmetic (the biased tail must be
    # equal); the long conv's float32 sums run in another order than the
    # plain version's einsums, with powers of the poles from repeated
    # squaring where the plain version takes a log-doubling range: y
    # agrees to float32 rounding before it is rounded to bf16, so an output
    # may land one bf16 step (2^-8 to 2^-7 of its size) away. Required:
    # |err| <= 2^-6 of the larger of |want| and its (batch, channel) row's
    # rms, at least 99 % of the outputs equal, and the float32 modal state
    # within 1e-4 of the same scale.
    def modal_params(C, S):
        mag = torch.rand(C, S, device=dev, generator=g) * 0.48 + 0.5
        ang = (torch.rand(C, S, device=dev, generator=g) * 2 - 1) * 3.1
        poles = torch.stack([mag * torch.cos(ang), mag * torch.sin(ang)], -1)
        return poles, torch.randn(C, S, 2, device=dev, generator=g) * 0.3

    S, chunk = 8, 64
    err6 = scaled6 = state6 = 0.0
    equal6 = 1.0
    for B, L, carried in ((1, 8192, False), (1, 8192, True),
                          (2, 512, False), (2, 512, True),
                          (2, 37, True)):     # one chunk of odd width
        zl, fw, fb = (randn(B, L, 3, D), randn(3, D, 3) * 0.5,
                      randn(3, D) * 0.1)
        z, b_in = zl.permute(0, 2, 3, 1), randn(3, D)
        poles, residues = modal_params(D, S)
        d_skip = randn(D)
        st = (randn(B, 3, D, 2), randn(B, D, S, 2).float()) if carried \
            else None
        check(hyena_mixer_supported(z.shape, chunk, S, 3), 'support rule')
        got = hyena_mixer(z, fw, fb, poles, residues, d_skip, chunk=chunk,
                          state=st, b_in=b_in)
        torch.cuda.synchronize()
        want = hyena_mixer_plain(z, fw, fb, poles, residues, d_skip,
                                 chunk=chunk, state=st, b_in=b_in)
        check(got[0].transpose(1, 2).is_contiguous(),
              'hyena_mixer: y does not lie as (B, L, C)')
        e = float((got[0].float() - want[0].float()).abs().max())
        r = scaled_err(got[0], want[0])
        eq = float((got[0] == want[0]).float().mean())
        rs = scaled_err(got[1].flatten(2), want[1].flatten(2))
        log(f'   hyena_mixer B={B} L={L} carried state={carried}: max abs '
            f'err {e:.3e}, scaled {r:.3e}, equal {eq:.6f}; modal state '
            f'scaled {rs:.3e}; FIR tail equal {torch.equal(got[2], want[2])}')
        check(torch.equal(got[2], want[2]), 'hyena_mixer FIR tail differs')
        err6, scaled6 = max(err6, e), max(scaled6, r)
        state6, equal6 = max(state6, rs), min(equal6, eq)
        del got, want
    check(scaled6 <= 2 ** -6 and equal6 >= 0.99 and state6 <= 1e-4,
          f'hyena_mixer kernel disagrees: {scaled6}, {equal6}, {state6}')
    zl, fw, fb = randn(1, 8192, 3, D), randn(3, D, 3) * 0.5, \
        randn(3, D) * 0.1
    z, b_in = zl.permute(0, 2, 3, 1), randn(3, D)
    st = (randn(1, 3, D, 2), randn(1, D, S, 2).float())
    n_pos = zl.numel() // 3
    # each input read once (zl, taps, both biases, d_skip, poles and
    # residues), each output written once (y and the modal state)
    nbytes = (zl.numel() + n_pos) * 2 \
        + (fw.numel() + fb.numel() + b_in.numel() + D) * 2 \
        + 2 * poles.numel() * 4 + D * S * 2 * 4
    # per chunk of Ct: the lower triangle of the Toeplitz product,
    # Ct (Ct + 1), injection and decay 2 * 2 S Ct each (complex states,
    # real u and y); per position the bias add, the FIR and the two
    # gates, 26
    flops = (n_pos // chunk) * (chunk * (chunk + 1) + 8 * S * chunk) \
        + 26 * n_pos
    bound6 = (1e3 * nbytes / peak['bytes_s'], 1e3 * flops / peak['fp32'])
    mixer_args = (fw, fb, poles, residues, d_skip)
    # six buffers of 201 MB in turns: each launch finds its input cold
    zls = [zl] + [randn(1, 8192, 3, D) for _ in range(5)]

    def mixer_on(zz, state=None):
        return lambda: hyena_mixer(zz.permute(0, 2, 3, 1), *mixer_args,
                                   chunk=chunk, state=state, b_in=b_in)
    kernels['hyena_mixer'] = dict(
        name='hyena_mixer', route='cuda',
        source='evo_tpu_torch/csrc/hyena_mixer.cu',
        replaces='evo_tpu/ops/pallas_hyena.py:69', max_abs_err=err6,
        max_scaled_err=scaled6, bit_equal_fraction=equal6,
        max_scaled_err_state=state6,
        ms=time_graph_ms(torch, [mixer_on(zz) for zz in zls]),
        carried_state_ms=time_graph_ms(torch,
                                       [mixer_on(zz, st) for zz in zls]),
        time_ms=time_ms(torch, mixer_on(zl)),
        carried_state_time_ms=time_ms(torch, mixer_on(zl, st)),
        plain_ms=time_ms(torch, lambda: hyena_mixer_plain(
            z, *mixer_args, chunk=chunk, b_in=b_in), reps=5, warmup=1),
        bound_ms=max(bound6),
        bound_by='bytes' if bound6[0] > bound6[1] else 'operations',
        library_ms=None, bound_bytes_ms=bound6[0],
        bound_operations_ms=bound6[1],
        # what the fused layer no longer runs before the kernel: the bias
        # pass and the (B, L, 3, C) -> (B, 3, C, L) copy
        route_before_ms=time_ms(
            torch, lambda: (zl + b_in).permute(0, 2, 3, 1).contiguous()),
        shape='zl (1, 8192, 3, 4096) bf16 with b_in, chunk 64, 8 modal '
              'states; no single PyTorch call computes this function')
    del mixer_args, st, poles, residues, d_skip, zls

    # The cross-chunk prefix. The kernel walks the chunks in segments (a
    # serial walk in each, the segments' end states handed on in order),
    # the plain version doubles (log2 K shifted passes) and adds a carried
    # state's a^k s0 terms after: the same sums in another order. Required:
    # |err| <= 2e-5 of the larger of |want| and the rms over its channel's
    # chunks and states (the tolerance at which the JAX package's test
    # holds its kernel to its loop), with and without a carried state.
    def prefix_case(B, K, C=D):
        inj = [torch.randn(B, C, K, S, device=dev, generator=g)
               for _ in range(2)]
        logmag = torch.log(torch.rand(C, S, device=dev, generator=g) * 0.48
                           + 0.5)
        theta = (torch.rand(C, S, device=dev, generator=g) * 2 - 1) * 3.1
        return (*inj, logmag, theta, chunk)

    err7 = scaled7 = 0.0
    for B, K in ((1, 128), (1, 188), (2, 8), (1, 2)):
        case = prefix_case(B, K)
        for s0 in (None, torch.randn(B, D, S, 2, device=dev, generator=g)):
            got = modal_prefix(*case, s0)
            torch.cuda.synchronize()
            want = modal_prefix_plain(*case, s0)
            e = max(float((a - b).abs().max()) for a, b in zip(got, want))
            r = max(scaled_err(a.flatten(2), b.flatten(2))
                    for a, b in zip(got, want))
            log(f'   modal_prefix B={B} K={K} carried state '
                f'{s0 is not None}: max abs err {e:.3e}, scaled {r:.3e}')
            err7, scaled7 = max(err7, e), max(scaled7, r)
    check(scaled7 <= 2e-5, f'modal_prefix kernel disagrees: {scaled7}')
    # a forward of 8,192 at chunk 64; five cases in turns, each 33.6 MB of
    # input, so that a launch finds its input cold
    cases = [prefix_case(1, 128) for _ in range(5)]
    s0 = torch.randn(1, D, S, 2, device=dev, generator=g)
    nbytes = (4 * cases[0][0].numel() + 2 * D * S + 2 * D * S) * 4
    kernels['modal_prefix'] = dict(
        name='modal_prefix', route='cuda',
        source='evo_tpu_torch/csrc/modal_prefix.cu',
        replaces='evo_tpu/ops/pallas_prefix.py:50', max_abs_err=err7,
        max_scaled_err=scaled7,
        ms=time_graph_ms(torch, [(lambda c=c: modal_prefix(*c))
                                 for c in cases]),
        ms_by_events=time_ms(torch, lambda: modal_prefix(*cases[0])),
        carried_state_ms=time_graph_ms(
            torch, [(lambda c=c: modal_prefix(*c, s0)) for c in cases]),
        plain_ms=time_ms(torch, lambda: modal_prefix_plain(*cases[0])),
        # 8 flops a complex multiply-add
        bound_ms=1e3 * max(nbytes / peak['bytes_s'],
                           8 * cases[0][0].numel() / peak['fp32']),
        bound_by='bytes', library_ms=None,
        shape='inj (1, 4096, 128, 8) fp32 x 2 (a forward of 8,192 at chunk '
              '64); ms replayed from a CUDA graph over five cold inputs, '
              'ms_by_events around one call with its wrapper; no single '
              'PyTorch call computes this function')
    del cases, s0, got, want

    # The fused MLP gate. Kernel and plain version both sum exact
    # bf16 x bf16 products in float32 (in another order), apply the
    # activation and the gate in float32 and round once to bf16, so an
    # output may land one bf16 step away: required |err| <= 2^-6 of the
    # larger of |want| and its row's rms.
    I = 10928
    w1, w2 = randn(D, I) * D ** -0.5, randn(D, I) * D ** -0.5
    err9 = scaled9 = 0.0
    # both tile shapes (64 x 64 at M <= 64, 128 x 128 above) and their
    # edges
    for M, act in ((8192, 'gelu'), (2, 'gelu'), (1000, 'silu'),
                   (77, 'gelu_tanh'), (1, 'gelu'), (63, 'gelu'),
                   (64, 'gelu'), (65, 'gelu'), (129, 'gelu')):
        x = randn(M, D)
        got = fused_gate(x, w1, w2, act)
        torch.cuda.synchronize()
        want = fused_gate_plain(x, w1, w2, act)
        e = float((got.float() - want.float()).abs().max())
        r = scaled_err(got, want)
        log(f'   mlp_gate M={M} {act}: max abs err {e:.3e}, scaled {r:.3e}')
        err9, scaled9 = max(err9, e), max(scaled9, r)
        del got, want
    x = randn(37, 100)        # D and I padded to multiples of 8
    wa, wb = randn(100, 1001) * 0.1, randn(100, 1001) * 0.1
    r = scaled_err(fused_gate(x, wa, wb), fused_gate_plain(x, wa, wb))
    log(f'   mlp_gate M=37 D=100 I=1001 gelu: scaled {r:.3e}')
    scaled9 = max(scaled9, r)
    check(scaled9 <= 2 ** -6, f'mlp_gate kernel disagrees: {scaled9}')

    def gate_bound_ms(M):
        nbytes = (M * D + 2 * D * I + M * I) * 2
        return (1e3 * nbytes / peak['bytes_s'],
                1e3 * 4 * M * D * I / peak['bf16'])

    by_rows9 = {}
    for M in (8192, 2):
        x = randn(M, D)
        by_rows9[M] = dict(
            ms=time_ms(torch, lambda: fused_gate(x, w1, w2), reps=10),
            plain_ms=time_ms(torch, lambda: fused_gate_plain(x, w1, w2),
                             reps=3, warmup=1),
            library_ms=time_ms(torch, lambda: F.gelu(x @ w1) * (x @ w2),
                               reps=10),
            bound_ms=max(gate_bound_ms(M)),
            bound_by='bytes' if gate_bound_ms(M)[0] > gate_bound_ms(M)[1]
            else 'operations')
    kernels['mlp_gate'] = dict(
        name='mlp_gate', route='cuda', source='evo_tpu_torch/csrc/mlp_gate.cu',
        replaces='evo_tpu/ops/pallas_mlp.py:55', max_abs_err=err9,
        max_scaled_err=scaled9, **by_rows9[8192], by_rows=by_rows9,
        shape='x (8192, 4096), w1, w2 (4096, 10928) bf16, gelu (by_rows: '
              'M = 8192 and 2); library: F.gelu(x @ w1) * (x @ w2), which '
              'rounds both products to bf16 first')
    log(f'   mlp_gate by rows: {by_rows9}')
    del w1, w2, wa, wb
    tp_shard_checks(torch, log, kernels, randn, D, H, Dh, S, chunk, buffers,
                    modal_params, prefix_case, dict(
                        fir_gate=fir_gate, fir_gate_plain=fir_gate_plain,
                        flash_attention_causal=flash_attention_causal,
                        attention_plain=attention_plain,
                        flash_attention_buffer=flash_attention_buffer,
                        attention_buffer_plain=attention_buffer_plain,
                        hyena_mixer=hyena_mixer,
                        hyena_mixer_plain=hyena_mixer_plain,
                        hyena_mixer_supported=hyena_mixer_supported,
                        modal_prefix=modal_prefix,
                        modal_prefix_plain=modal_prefix_plain))
    float32_weight_checks(
        torch, log, kernels, randn, D, S, chunk, peak, modal_params, dict(
            rmsnorm=rmsnorm, rmsnorm_plain=rmsnorm_plain, fir_gate=fir_gate,
            fir_gate_plain=fir_gate_plain, hyena_mixer=hyena_mixer,
            hyena_mixer_plain=hyena_mixer_plain))
    int4_grad_checks(torch, log, kernels, randn, peak, int4_case,
                     int4_bound_ms, dict(int4_matmul=int4_matmul,
                                         int4_matmul_plain=int4_matmul_plain))
    for kk in kernels.values():
        log(f"   {kk['name']}: {kk['ms']:.4f} ms (bound {kk['bound_ms']:.4f}"
            f" ms by {kk['bound_by']}, plain {kk['plain_ms']:.4f}, library "
            f"{kk['library_ms']}) at {kk['shape']}")
    del x, w, z, fw, fb, tail, qkv, q, k, v, qt, kt, vt

    # -- 3. the port on a small bf16 model: CUDA kernels vs plain on CPU --
    small = tiny_config(hidden_size=256, num_filters=256,
                        num_attention_heads=2, max_sequence_len=512,
                        compute_dtype='bfloat16', param_dtype='bfloat16')
    cpu_model = model_lib.random_init(
        small, torch.Generator().manual_seed(1), 'cpu')
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 100)))
    want = model_lib.forward(cpu_model, ids)
    got = model_lib.forward(cpu_model.to(dev), ids.to(dev)).cpu()
    rel = float((got - want).abs().max() / want.abs().max())
    log(f'== 3. small bf16 model, CUDA vs CPU plain path: max abs diff / '
        f'max |logit| = {rel:.3e}')
    # bf16 activations round at every layer on both sides, in different
    # places (cuBLAS vs CPU GEMM, kernel vs plain op order): 5% of the
    # logit range bounds that drift over 4 layers
    check(rel <= 5e-2 and torch.isfinite(got).all(),
          f'small model CUDA vs CPU: {rel}')
    del cpu_model

    # -- 4. scoring at full width -----------------------------------------
    t0 = time.time()
    evo = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda')
    torch.cuda.synchronize()
    log(f'== 4. evo-1-8k-base random init: {evo.model.num_params:,} '
        f'parameters in {time.time() - t0:.1f} s, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    rng = np.random.default_rng(0)
    seqs = [''.join(rng.choice(list('ACGT'), n))
            for n in (1000, 2300, 3100, 4000)]
    score_sequences(seqs[:1], evo.model, evo.tokenizer)   # warm-up
    torch.cuda.synchronize()
    launches = dict(phase2_launches)

    _build.LAUNCHES.clear()
    t0 = time.time()
    scores = score_sequences(seqs, evo.model, evo.tokenizer)
    score_s = time.time() - t0
    launches['score_sequences'] = dict(_build.LAUNCHES)
    log(f'   score_sequences 4 x {[len(s) for s in seqs]} nt: {scores} in '
        f'{score_s:.3f} s ({sum(map(len, seqs)) / score_s:.0f} nt/s); '
        f'launches {launches["score_sequences"]}')
    check(all(np.isfinite(scores)) and all(s < 0 for s in scores),
          f'scores {scores}')
    per_forward = {'rmsnorm': 65, 'fir_gate': 29, 'flash_attention': 3}
    check(launches['score_sequences'] == per_forward,
          f'launches {launches["score_sequences"]}')
    # right padding never changes a causal model's earlier positions
    alone = score_sequences(seqs[:1], evo.model, evo.tokenizer)[0]
    check(abs(alone - scores[0]) <= 1e-2,
          f'padding changed the score: {alone} vs {scores[0]}')

    ids = rng.integers(65, 85, (1, 8192))
    evo.model(ids)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.time()
    logits, _ = evo.model(ids)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    launches['forward_8192'] = dict(_build.LAUNCHES)
    check(launches['forward_8192'] == per_forward,
          f'launches {launches["forward_8192"]}')
    check(tuple(logits.shape) == (1, 8192, 512)
          and bool(torch.isfinite(logits).all()), 'forward logits')
    log(f'   forward B=1 L=8192: {fwd_s:.3f} s, {8192 / fwd_s:.0f} tokens/s, '
        f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    unfused_logits = logits
    del logits

    # -- 5. generation at full width ----------------------------------------
    prompts = [''.join(rng.choice(list('ACGT'), 512)) for _ in range(2)]
    n_new = 64
    generate(prompts, evo.model, evo.tokenizer, n_tokens=2, verbose=0)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.time()
    out, gen_scores = generate(prompts, evo.model, evo.tokenizer,
                               n_tokens=n_new, verbose=0)
    gen_s = time.time() - t0
    launches['generate'] = dict(_build.LAUNCHES)
    # every decode step reads the bf16 cache through kernel 4 at one row:
    # its split key range, then the combine kernel
    want = {'rmsnorm': 65 * n_new, 'fir_gate': 29, 'flash_attention': 3,
            'flash_attention_buffer': 3 * (n_new - 1),
            'combine_partials': 3 * (n_new - 1)}
    check(launches['generate'] == want, f'launches {launches["generate"]}')
    check(all(len(s) == n_new for s in out)
          and all(np.isfinite(gen_scores)), f'generation {gen_scores}')
    prompt_ids = prepare_batch(prompts, evo.tokenizer, prepend_bos=False)[0]

    def prefill_and_decode(model, n_steps):
        cache = model.initialize_inference_params(
            2, prompt_ids.shape[1] + n_steps + 1)
        logits, cache = model(prompt_ids, inference_params_dict=cache)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(n_steps):
            step, cache = model_lib.decode_step(model.module, tok, cache)
            tok = step.argmax(-1)
        torch.cuda.synchronize()
        return time.time() - t

    t0 = time.time()
    decode_s = prefill_and_decode(evo.model, 32)
    prefill_s = time.time() - t0 - decode_s
    log(f'== 5. generate 2 x 512 nt + {n_new}: {gen_s:.3f} s '
        f'({2 * n_new / gen_s:.1f} tokens/s end to end); prefill '
        f'{prefill_s:.3f} s; decode {1e3 * decode_s / 32:.2f} ms per step, '
        f'{2 * 32 / decode_s:.1f} tokens/s; launches {launches["generate"]}')

    # The decode path (GEMV, dense float32 attention, modal recurrence)
    # rounds its bf16 activations in other places than the full-sequence
    # path (GEMM, flash kernel, chunked conv), and 32 layers of random
    # weights amplify each rounding. The yardstick for that: the same
    # forward with ONE extra bf16 rounding step (a relative 2^-8 of
    # random sign) on the output of layer 0's first norm.
    sign = torch.randint(0, 2, (1, 1, 4096), device=dev, generator=g)
    # Its size moves with the 4,096 signs: over 8 draws by 1.0-1.4x
    # (`tools/yardstick_draws.py`), as far as the distances of phase 18
    # under int4 lie below it. So the teacher-forcing checks of decode,
    # serving and speculation (`seam_check`, `teacher_forced`,
    # `spec_teacher_forced`) hold against the median over four fixed
    # draws of a generator of their own; `sign`, the one draw of `g`,
    # stays the yardstick of the other checks and is logged beside.
    g36 = torch.Generator(device=dev).manual_seed(36)
    signs4 = [torch.randint(0, 2, (1, 1, 4096), device=dev, generator=g36)
              for _ in range(4)]
    yardsticks = []

    def nudged_draws(model, tokens):
        """One forward over `tokens` (B, L) five times in one batch: as it
        is (a sign of 0.5 nudges by 0), then under each of the four draws;
        logits (5, B, L, V). Each draw's yardstick is its distance from
        the first, at the same batch shape."""
        B = tokens.shape[0]
        s = torch.cat([torch.full_like(sign, 0.5, dtype=torch.float32)]
                      + [t.float() for t in signs4]).repeat_interleave(B, 0)
        logits = nudged_forward(model, tokens.repeat(5, 1), s)
        return logits.view(5, B, *logits.shape[1:])

    def nudged_forward(model, tokens, s=None):
        s = sign if s is None else s
        hook = model.module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * s - 1) * 2.0 ** -8).to(
                out.dtype))
        logits, _ = model(tokens)
        hook.remove()
        return logits

    def median_yardstick(what, distance, per_draw, single):
        """The median of the four draws' yardsticks, with `g`'s one draw
        logged and kept beside it."""
        med = statistics.median(per_draw)
        yardsticks.append(dict(check=what, distance=distance, median4=med,
                               draws=per_draw, single_draw=single))
        log(f'   yardstick of {what}: distance {distance:.5f}, median of 4 '
            f'draws {med:.5f} ({", ".join(f"{x:.5f}" for x in per_draw)}), '
            f'the single draw {single:.5f}')
        return med

    def seam_check(model, label):
        """Prefill + decode logits of a greedy generation against one
        forward over prompt + generation. A fault (a wrong position, cache
        slot or state) moves logits by their own spread and leaves argmax
        agreement near chance; the seam must stay within the one rounding
        step's drift."""
        toks, step_logits, _ = Generator(model, evo.tokenizer, top_k=1,
                                         temperature=0.0).generate(
            input_ids=prompt_ids, num_tokens=n_new)
        full = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(),
                          toks], dim=1)
        ref, _ = model(full)
        ref = ref[:, 511:511 + n_new]
        diff = (step_logits - ref).abs()
        agree = float((step_logits.argmax(-1) == ref.argmax(-1)).float()
                      .mean())
        floor = (nudged_forward(model, full)[:, 511:511 + n_new] - ref).abs()
        draws = nudged_draws(model, full)[:, :, 511:511 + n_new]
        yard = median_yardstick(
            f'the seam{label}', float(diff.mean()),
            [float((draws[k] - draws[0]).abs().mean()) for k in range(1, 5)],
            float(floor.mean()))
        steps = [0, 1, 2, 8, 32, n_new - 1]
        log(f'   seam{label}: prefill+decode vs forward logits: max abs diff '
            f'{float(diff.max()):.4f}, mean {float(diff.mean()):.5f} (by '
            f'step {[round(float(diff[:, s].mean()), 5) for s in steps]}), '
            f'argmax agreement {agree:.4f}; logit std '
            f'{float(ref.std()):.3f}; one rounding step at layer 0 moves '
            f'them by max {float(floor.max()):.4f}, mean '
            f'{float(floor.mean()):.5f} (median of 4 draws {yard:.5f})')
        check(float(diff.mean()) <= yard and agree >= 0.75,
              f'seam logits disagree{label}')

    seam_check(evo.model, '')

    # -- 13. the fused-mixer configuration, evo-1-8k-base at full width ----
    # Same seed, so the same weights; `hyena_fused_mixer` swaps the FIR +
    # gate kernel and the plain long conv of every Hyena layer for the
    # fused kernel wherever the length is a multiple of the chunk (64).
    t0 = time.time()
    evo_f = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda',
                config_overrides=dict(hyena_fused_mixer=True))
    torch.cuda.synchronize()
    log(f'== 13. evo-1-8k-base with hyena_fused_mixer=True: made in '
        f'{time.time() - t0:.1f} s')
    check(torch.equal(evo_f.model.module.blocks[0].hyena.w_in,
                      evo.model.module.blocks[0].hyena.w_in)
          and evo_f.config == evo.config.replace(hyena_fused_mixer=True),
          'the fused model is not the unfused one under another config')

    def expect_fused(L):
        """Launches a forward of length L makes under the fused mixer:
        the shape rule of `hyena_full`, worked out here from L alone."""
        fused = L >= 3 and L % min(64, L) == 0
        return {'rmsnorm': 65, 'flash_attention': 3,
                ('hyena_mixer' if fused else 'fir_gate'): 29}

    # (a) ragged batches: the one of phase 4 pads to 4,001 tokens (with the
    # BOS) and falls through; one whose longest sequence has 4,095 nt pads
    # to 4,096 and takes the fused kernel. Both against the unfused model
    # within 1e-2, the limit the padding check uses.
    aligned = seqs[:3] + [seqs[3] + ''.join(
        np.random.default_rng(13).choice(list('ACGT'), 95))]
    for label, batch in (('ragged', seqs), ('aligned', aligned)):
        L = prepare_batch(batch, evo.tokenizer)[0].shape[1]
        want = score_sequences(batch, evo.model, evo.tokenizer)
        score_sequences(batch[:1], evo_f.model, evo_f.tokenizer)  # warm-up
        _build.LAUNCHES.clear()
        t0 = time.time()
        got = score_sequences(batch, evo_f.model, evo_f.tokenizer)
        dt = time.time() - t0
        launches[f'fused_score_sequences_{label}'] = dict(_build.LAUNCHES)
        worst = max(abs(a - b) for a, b in zip(got, want))
        log(f'   score_sequences, {label} batch padded to {L}: {got} in '
            f'{dt:.3f} s ({sum(map(len, batch)) / dt:.0f} nt/s), largest '
            f'difference from the unfused scores {worst:.2e}; launches '
            f'{dict(_build.LAUNCHES)}')
        check(dict(_build.LAUNCHES) == expect_fused(L),
              f'launches {dict(_build.LAUNCHES)} for L={L}')
        check(all(np.isfinite(got)) and worst <= 1e-2, f'fused scores {got}')
    check(launches['fused_score_sequences_ragged'].get('hyena_mixer', 0) == 0
          and launches['fused_score_sequences_aligned']['hyena_mixer'] == 29,
          'the two batches must fall on both sides of the shape rule')

    # (b) one forward at B=1, L=8192: launches, logits against the unfused
    # forward of phase 4 within the one-rounding yardstick, and time and
    # peak memory of the two models in turns
    evo_f.model(ids)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    fused_logits, _ = evo_f.model(ids)
    torch.cuda.synchronize()
    launches['fused_forward_8192'] = dict(_build.LAUNCHES)
    check(launches['fused_forward_8192'] == expect_fused(8192),
          f'launches {launches["fused_forward_8192"]}')
    floor = (nudged_forward(evo.model, ids) - unfused_logits).abs()

    def logit_drift(label, got):
        diff = (got - unfused_logits).abs()
        agree = float((got.argmax(-1) == unfused_logits.argmax(-1)).float()
                      .mean())
        log(f'   {label} vs unfused forward logits: mean abs diff '
            f'{float(diff.mean()):.5f} (max {float(diff.max()):.4f}), '
            f'argmax agreement {agree:.4f}; one rounding step at layer 0 '
            f'moves them by mean {float(floor.mean()):.5f}; limit 1x')
        check(bool(torch.isfinite(got).all())
              and float(diff.mean()) <= float(floor.mean()),
              f'{label}: logits disagree with the unfused forward')

    logit_drift('fused forward B=1 L=8192', fused_logits)
    del fused_logits

    def timed_forward(model):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.time()
        model(ids)
        torch.cuda.synchronize()
        return (time.time() - t,
                (torch.cuda.max_memory_allocated() - base) / 2**30)

    turns = [(name, *timed_forward(m)) for name, m in (
        ('unfused', evo.model), ('fused', evo_f.model),
        ('fused', evo_f.model), ('unfused', evo.model))]
    log('   forward B=1 L=8192 in turns (seconds, tokens/s, peak GiB above '
        'what was allocated before): ' + ', '.join(
            f'{name} {dt:.4f} s {8192 / dt:.0f} tok/s {gib:.2f} GiB'
            for name, dt, gib in turns))

    # (c) greedy generation from the prompts of phase 5: a prefill of 512
    # (8 chunks) through the fused kernel, decode steps as before
    generate(prompts, evo_f.model, evo_f.tokenizer, n_tokens=2, verbose=0)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.time()
    out_f, scores_f = generate(prompts, evo_f.model, evo_f.tokenizer,
                               n_tokens=n_new, verbose=0)
    gen_f_s = time.time() - t0
    launches['fused_generate'] = dict(_build.LAUNCHES)
    check(launches['fused_generate'] == {
        'rmsnorm': 65 * n_new, 'hyena_mixer': 29, 'flash_attention': 3,
        'flash_attention_buffer': 3 * (n_new - 1),
        'combine_partials': 3 * (n_new - 1)},
        f'launches {launches["fused_generate"]}')
    check(all(len(s) == n_new for s in out_f)
          and all(np.isfinite(scores_f)), f'generation {scores_f}')
    t0 = time.time()
    decode_f_s = prefill_and_decode(evo_f.model, 32)
    prefill_f_s = time.time() - t0 - decode_f_s
    t0 = time.time()
    decode_u_s = prefill_and_decode(evo.model, 32)
    prefill_u_s = time.time() - t0 - decode_u_s
    log(f'   generate 2 x 512 nt + {n_new} under the fused mixer: '
        f'{gen_f_s:.3f} s ({2 * n_new / gen_f_s:.1f} tokens/s end to end; '
        f'unfused in phase 5: {gen_s:.3f} s); prefill {prefill_f_s:.3f} s '
        f'fused, {prefill_u_s:.3f} s unfused; decode '
        f'{1e3 * decode_f_s / 32:.2f} ms per step after the fused prefill, '
        f'{1e3 * decode_u_s / 32:.2f} after the unfused; launches '
        f'{launches["fused_generate"]}')
    seam_check(evo_f.model, ' under the fused mixer')

    # (d) the fused MLP gate on a real layer: the input of layer 0's MLP
    # for 8,192 tokens, through `fused_gate` with the layer's w1 and w2,
    # against the first half of `layers/mlp.py` (two bf16 projections, the
    # activation and the gate each rounded to bf16: up to four bf16 steps,
    # so 2^-5 of the larger of the value and its row's rms) and against
    # the plain version (2^-6 as in phase 2). No model path calls the
    # kernel, in either package; this call stands for its main path.
    mlp = evo.model.module.blocks[0].mlp
    seen = []
    hook = mlp.register_forward_hook(lambda mod, inp, out: seen.append(inp[0]))
    evo.model(ids)
    hook.remove()
    h = seen[0]
    _build.LAUNCHES.clear()
    got = fused_gate(h, mlp.w1, mlp.w2, evo.config.mlp_activation)
    torch.cuda.synchronize()
    launches['mlp_gate_layer'] = dict(_build.LAUNCHES)
    layer_half = mlp.act(h @ mlp.w1) * (h @ mlp.w2)
    r_layer = scaled_err(got, layer_half)
    r_plain = scaled_err(got, fused_gate_plain(
        h, mlp.w1, mlp.w2, evo.config.mlp_activation))
    log(f'   fused_gate on layer 0 (input {tuple(h.shape)}): scaled err '
        f'{r_layer:.3e} against the layer\'s own first half (limit 2^-5), '
        f'{r_plain:.3e} against the plain version (limit 2^-6); launches '
        f'{launches["mlp_gate_layer"]}')
    check(launches['mlp_gate_layer'] == {'mlp_gate': 1}
          and r_layer <= 2 ** -5 and r_plain <= 2 ** -6,
          'fused_gate disagrees with the layer')
    del seen, h, got, layer_half, mlp, evo_f

    # (e) `hyena_pallas_prefix=True` alone: the unfused path with the
    # prefix kernel in the long conv
    evo_p = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda',
                config_overrides=dict(hyena_pallas_prefix=True))
    evo_p.model(ids)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.time()
    prefix_logits, _ = evo_p.model(ids)
    torch.cuda.synchronize()
    prefix_s = time.time() - t0
    launches['prefix_forward_8192'] = dict(_build.LAUNCHES)
    check(launches['prefix_forward_8192'] == {
        'rmsnorm': 65, 'fir_gate': 29, 'modal_prefix': 29,
        'flash_attention': 3}, f'launches {launches["prefix_forward_8192"]}')
    logit_drift(f'forward B=1 L=8192 under hyena_pallas_prefix '
                f'({prefix_s:.4f} s, {8192 / prefix_s:.0f} tokens/s)',
                prefix_logits)
    del evo_p, prefix_logits

    # -- 26. the FFT long-conv backend, evo-1-8k-base at full width --------
    # Same seed, so the same weights; `hyena_conv_backend='fft'` swaps each
    # Hyena layer's chunked Toeplitz conv for real FFTs (cuFFT) after the
    # same FIR + gate kernel, and ignores `hyena_fused_mixer` (set here to
    # show it). (a) one forward at B=1, L=8192: the launches, the logits
    # against the matmul backend's within the one-rounding yardstick, time
    # and peak memory of both in turns.
    t26 = time.time()
    log(f'== 26. the FFT long-conv backend, evo-1-8k-base ({smi})')
    evo_fft = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda',
                  config_overrides=dict(hyena_conv_backend='fft',
                                        hyena_fused_mixer=True))
    check(torch.equal(evo_fft.model.module.blocks[0].hyena.poles,
                      evo.model.module.blocks[0].hyena.poles),
          'the FFT model is not the matmul one under another config')
    evo_fft.model(ids)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    fft_logits, _ = evo_fft.model(ids)
    torch.cuda.synchronize()
    launches['fft_forward_8192'] = dict(_build.LAUNCHES)
    check(launches['fft_forward_8192'] == per_forward,
          f'launches {launches["fft_forward_8192"]}: the FFT backend runs '
          f'kernels 1-3 as the matmul one does, and no fused mixer')
    logit_drift('FFT backend forward B=1 L=8192', fft_logits)
    del fft_logits
    turns = [(name, *timed_forward(m)) for name, m in (
        ('matmul', evo.model), ('fft', evo_fft.model), ('matmul', evo.model),
        ('fft', evo_fft.model), ('matmul', evo.model),
        ('fft', evo_fft.model))]
    log('   forward B=1 L=8192 in turns (seconds, tokens/s, peak GiB '
        'above what was allocated before): ' + ', '.join(f'{name} {dt:.4f} s {8192 / dt:.0f} tok/s '
                                 f'{gib:.2f} GiB'
                                 for name, dt, gib in turns))
    res26 = dict(forward_8192={name: [(dt, gib) for n, dt, gib in turns
                                      if n == name]
                               for name in ('matmul', 'fft')})

    # (b) greedy generation from phase 5's prompts, 32 tokens: a monolithic
    # FFT prefill of 512, the modal state scanned for decode
    # (modal_prefill_state), decode steps as before; the step logits
    # against the matmul backend's teacher-forced forward over prompt +
    # generation, within phase 5's yardstick
    n_fft = 32
    gen = Generator(evo_fft.model, evo_fft.tokenizer, top_k=1,
                    temperature=0.0)
    gen.generate(input_ids=prompt_ids, num_tokens=2)      # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.time()
    toks, step_logits, _ = gen.generate(input_ids=prompt_ids,
                                        num_tokens=n_fft)
    torch.cuda.synchronize()
    gen_fft_s = time.time() - t0
    launches['fft_generate'] = dict(_build.LAUNCHES)
    check(launches['fft_generate'] == {
        'rmsnorm': 65 * n_fft, 'fir_gate': 29, 'flash_attention': 3,
        'flash_attention_buffer': 3 * (n_fft - 1),
        'combine_partials': 3 * (n_fft - 1)},
        f'launches {launches["fft_generate"]}')
    full = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(), toks],
                     dim=1)
    ref, _ = evo.model(full)
    ref = ref[:, 511:511 + n_fft]
    diff = (step_logits - ref).abs()
    agree = float((step_logits.argmax(-1) == ref.argmax(-1)).float().mean())
    floor_g = (nudged_forward(evo.model, full)[:, 511:511 + n_fft]
               - ref).abs()
    log(f'   generate 2 x 512 nt + {n_fft} under the FFT backend: '
        f'{gen_fft_s:.3f} s; step logits against the matmul backend '
        f'teacher-forced: mean abs diff {float(diff.mean()):.5f} (max '
        f'{float(diff.max()):.4f}), argmax agreement {agree:.4f}; one '
        f'rounding step at layer 0 moves them by mean '
        f'{float(floor_g.mean()):.5f}; launches {launches["fft_generate"]}')
    check(float(diff.mean()) <= float(floor_g.mean()) and agree >= 0.75,
          'FFT-backend generation disagrees with the matmul backend')
    res26.update(generate_s=gen_fft_s, generate_diff=float(diff.mean()),
                 generate_floor=float(floor_g.mean()), agree=agree)
    del evo_fft, gen, toks, step_logits, full, ref, diff, floor_g
    res26['seconds_8k'] = time.time() - t26
    del unfused_logits, floor

    # -- 16. continuous-batching serving, evo-1-8k-base at full width -------
    # `GenerationServer` over the unfused bf16 model: 4 slots of 2,048
    # positions, decode chunks of 8 steps, prompts prefilled in chunks of
    # 128 (a fresh first chunk through kernel 3, the rest resumed through
    # kernel 4), a pair of same-length prompts in one batched prefill.
    # Ten requests: eight queued before the first step (the 512-nt pair
    # first, so it fills as a pair), two more after the second step; three
    # sampled (temperature 1, top-k 4, seeds of their own).
    log(f'== 16. serving, evo-1-8k-base ({smi})')
    rng16 = np.random.default_rng(16)
    plens = [512, 512, 96, 200, 333, 700, 1000, 1500, 300, 900]
    news = [int(n) for n in rng16.integers(48, 97, len(plens))]
    sampled16 = (1, 3, 8)
    prompts16 = [''.join(rng16.choice(list('ACGT'), n)) for n in plens]
    chunk_events = []

    def timed_chunk(*a, **kw):
        """`serving._decode_chunk` between two CUDA events (no sync)."""
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_chunk(*a, **kw)
        ev[1].record()
        chunk_events.append(ev)
        return out

    real_chunk = serving_mod._decode_chunk
    serving_mod._decode_chunk = timed_chunk

    def submit16(server, idxs):
        return {i: server.submit(
            prompt=prompts16[i], num_tokens=news[i],
            temperature=1.0 if i in sampled16 else 0.0,
            top_k=4 if i in sampled16 else None, seed=1000 + i)
            for i in idxs}

    def new_server16():
        return GenerationServer(evo.model, evo.tokenizer, max_slots=4,
                                max_len=2048, steps_per_sync=8,
                                prompt_chunk=128, prefill_batch=2)

    warm = new_server16()                   # cuBLAS's first calls
    for i in (0, 1, 2):
        warm.submit(prompt=prompts16[i][:300], num_tokens=9)
    warm.run()
    del warm
    server16 = new_server16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    chunk_events.clear()
    t0 = time.time()
    rids16 = submit16(server16, range(8))
    server16.step()
    server16.step()
    rids16.update(submit16(server16, (8, 9)))
    results16 = server16.run()
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches['serve_8k'] = dict(_build.LAUNCHES)
    chunk_ms = [a.elapsed_time(b) for a, b in chunk_events]
    check(all(len(results16[r].token_ids) == news[i]
              and not results16[r].cancelled for i, r in rids16.items()),
          'a request of phase 16 did not end with its token count')
    check(2 in server16._prefill_caches, 'the 512-nt pair did not fill as '
          'one batched prefill')

    def fill_launches(P):
        """Launches of one fill of P-token prompts: a fresh first chunk
        (kernel 3), resumed chunks (kernel 4; a tail of up to
        SPLIT_MAX_ROWS_BF16 tokens through its split and the combine
        kernel), each a forward's RMSNorms and FIR + gates."""
        head = server16._head_len(P)
        n = head // 128 + 1
        tail_split = bool(head) and (
            P - head <= attention_buffer_mod.SPLIT_MAX_ROWS_BF16)
        return collections.Counter({
            'rmsnorm': 65 * n, 'fir_gate': 29 * n, 'flash_attention': 3,
            'flash_attention_buffer': 3 * (n - 1),
            'combine_partials': 3 * tail_split})

    n_steps16 = 8 * len(chunk_ms)
    want16 = collections.Counter({'rmsnorm': 65 * n_steps16,
                                  'flash_attention_buffer': 3 * n_steps16,
                                  'combine_partials': 3 * n_steps16})
    for P in plens[1:]:                     # the pair is one fill
        want16 += fill_launches(P)
    check(launches['serve_8k'] == dict(want16),
          f'launches {launches["serve_8k"]}, expected {dict(want16)}')
    # Teacher forcing: one forward over each prompt + generation. The
    # log-prob the server recorded for each token against that forward's
    # log_softmax at the same position, within the drift of one bf16
    # rounding step at layer 0 (phase 5's yardstick); greedy tokens
    # against the forward's argmax, agreement >= 0.75 as in phase 5.

    def teacher_forced(model, tokenizer, prompts, results, rids, greedy):
        """(mean and max |recorded log-prob - forward's|, the yardstick's
        mean over every request's tokens (median of the four draws),
        greedy argmax agreement)."""
        diffs, agree, floors, draws = [], [], [], []
        for i, rid in rids.items():
            res = results[rid]
            P = len(prompts[i])
            full = torch.as_tensor(np.concatenate([
                tokenizer.tokenize(prompts[i]), res.token_ids]),
                device=dev).long()[None]
            toks = full[0, P:]
            ref = torch.log_softmax(model(full)[0][0, P - 1:-1].float(), -1)
            nud = torch.log_softmax(
                nudged_forward(model, full)[0, P - 1:-1].float(), -1)
            lp_ref = ref.gather(-1, toks[:, None])[:, 0]
            diffs.append((torch.as_tensor(res.logps, device=dev)
                          - lp_ref).abs())
            floors.append((nud.gather(-1, toks[:, None])[:, 0]
                           - lp_ref).abs())
            lp = torch.log_softmax(nudged_draws(model, full)[
                :, 0, P - 1:-1].float(), -1).gather(
                    -1, toks[None, :, None].expand(5, -1, 1))[..., 0]
            draws.append((lp[1:] - lp[:1]).abs())
            if i in greedy:
                agree.append((ref.argmax(-1) == toks).float())
        d, draws = torch.cat(diffs), torch.cat(draws, dim=1)
        f = median_yardstick(
            'teacher forcing', float(d.mean()),
            [float(x) for x in draws.mean(dim=1)],
            float(torch.cat(floors).mean()))
        return (float(d.mean()), float(d.max()), f,
                float(torch.cat(agree).mean()))

    d16, dmax16, f16, agree16 = teacher_forced(
        evo.model, evo.tokenizer, prompts16, results16, rids16,
        [i for i in range(10) if i not in sampled16])
    total16 = sum(news)
    log(f'   10 requests ({plens} nt, {total16} new tokens, 3 sampled) on 4 '
        f'slots: {serve_s:.3f} s, {total16 / serve_s:.1f} generated tokens/s '
        f'aggregate; {len(chunk_ms)} decode chunks of 8 steps, median '
        f'{statistics.median(chunk_ms):.2f} ms a chunk, '
        f'{statistics.median(chunk_ms) / 8:.2f} ms a step (CUDA events); '
        f'peak {serve_peak:.2f} GiB; launches {launches["serve_8k"]}')
    log(f'   teacher forcing: recorded log-probs vs one forward: mean abs '
        f'diff {d16:.5f} (max {dmax16:.4f}); one rounding step at layer 0 '
        f'moves them by mean {f16:.5f} (limit 1x); greedy argmax agreement '
        f'{agree16:.4f} (limit 0.75)')
    check(d16 <= f16 and agree16 >= 0.75,
          'served log-probs disagree with teacher forcing')
    del results16
    # Kernel 4 at one query row over the slot batch's cache (B=4, T=2,048)
    # with per-row device offsets, beside the same batch with every row at
    # the longest offset and one row alone: the kernel's grid is a block a
    # (row, head), each walking its own row's key tiles.
    attn_idx = evo.config.attn_layer_idxs[0]
    kb16 = server16._cache['layers'][attn_idx]['k']
    vb16 = server16._cache['layers'][attn_idx]['v']
    q16 = torch.randn((4, 1, 32, 128), device=dev,
                      generator=g).bfloat16()
    k4 = {}
    for label, qq, kk_, vv, off, offs in (
            ('per-row (95, 699, 1499, 2047)', q16, kb16, vb16,
             torch.tensor([95, 699, 1499, 2047], dtype=torch.int32,
                          device=dev), (95, 699, 1499, 2047)),
            ('every row at 2047', q16, kb16, vb16,
             torch.full((4,), 2047, dtype=torch.int32, device=dev),
             (2047,) * 4),
            ('one row at 2047', q16[:1], kb16[:1], vb16[:1], 2047,
             (2047,))):
        k4[label] = (time_graph_ms(torch, [lambda: flash_attention_buffer(
            qq, kk_, vv, off)]), live_kv_bound_ms(peak, offs, False))
    log('   kernel 4 at one query row, T=2,048 (graph replay; bound by the '
        'live K, V bytes): ' + ', '.join(
            f'{k} {v[0]:.4f} ms (bound {v[1]:.4f})' for k, v in k4.items()))
    # one step() with no fill pending, in the profiler: no host read
    # inside the decode chunk, one readback of the chunk
    from torch.profiler import ProfilerActivity, profile
    for i in range(4):
        server16.submit(prompt=prompts16[9][64 * i:64 * i + 64],
                        num_tokens=40)
    server16.step()
    check(server16._fill is None and not server16._queue
          and all(r is not None for r in server16._slots),
          'the profiled step would run a fill')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        server16.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t)
    scalar_reads = sum(e.name == 'aten::_local_scalar_dense'
                       for e in prof.events())
    readbacks = sum('DtoH' in e.name or 'Device -> Pageable' in e.name
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, 'is_user_annotation', False))
    log(f'   profile of one step() (a chunk of 8 decode steps at B=4, no '
        f'fill): device busy {busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} '
        f'ms wall under the profiler (idle share '
        f'{1 - busy_us / wall_us:.3f}; against the median chunk of the run '
        f'without it, {statistics.median(chunk_ms):.1f} ms: '
        f'{1 - busy_us / 1e3 / statistics.median(chunk_ms):.3f}); '
        f'{scalar_reads} aten::_local_scalar_dense, {readbacks} '
        f'device-to-host copies')
    check(scalar_reads == 0 and readbacks == 1,
          f'the decode chunk read the device: {scalar_reads} scalar reads, '
          f'{readbacks} device-to-host copies')
    server16.run()
    del server16, kb16, vb16, q16

    # -- 18. n-gram speculative decoding, evo-1-8k-base at full width ------
    # `generate_speculative` at B=1, g = 8, 32 new tokens from a 512-nt
    # prompt, a tandem repeat of a 64-nt unit and a random one, beside the
    # port's greedy `generate` on the same prompt (in turns: greedy, spec,
    # spec, greedy over the two prompts). Every engine call is recorded by
    # its length, so the launch counts follow from the run's own schedule:
    # 65 RMSNorms a call, kernel 3 at the fresh prefill, kernel 4 at every
    # resumed call (verify passes and replays), FIR + gate at every call
    # of 3 positions or more. The log-probs against one forward over
    # prompt + generation (teacher forcing), within phase 5's yardstick.
    from evo_tpu_torch import generate_speculative, runtime
    from evo_tpu_torch.tools.spec_agreement import OracleDrafter
    from evo_tpu_torch.io import fasta as fasta_mod
    from evo_tpu_torch.io import fastio
    log(f'== 18. speculative decoding, evo-1-8k-base ({smi}); '
        f'{runtime.device_memory_report()}')
    check('GiB' in runtime.device_memory_report(), 'device memory report')
    rng18 = np.random.default_rng(18)
    unit18 = ''.join(rng18.choice(list('ACGT'), 64))
    prompts18 = {'repetitive': unit18 * 8,
                 'non-repetitive': ''.join(rng18.choice(list('ACGT'), 512))}

    class CallLog:
        """The engine facade with each call's length recorded."""

        def __init__(self, model):
            self.model, self.lengths = model, []

        def initialize_inference_params(self, b, t):
            return self.model.initialize_inference_params(b, t)

        def __call__(self, ids, **kw):
            self.lengths.append(np.shape(ids)[-1])
            return self.model(ids, **kw)

    def spec_run(model, prompt, n, gamma, oracle=None):
        """(tokens, log-probs, stats, seconds, launches, call lengths).
        With an `OracleDrafter`, its proposals replace the n-gram
        index's, and its own launches and seconds are left out of the
        run's."""
        calls = CallLog(model)
        with (oracle.installed() if oracle is not None
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t = time.time()
            toks, logps, stats = generate_speculative(
                calls, tok, prompt=prompt, num_tokens=n, gamma=gamma)
            torch.cuda.synchronize()
            secs = time.time() - t
        counts = collections.Counter(_build.LAUNCHES)
        if oracle is not None:
            secs -= oracle.seconds
            counts.subtract(oracle.launches)
        return (toks, logps, stats, secs, {k: v for k, v in counts.items()
                                           if v}, calls.lengths)

    def check_schedule_ran(lengths, gamma, stats, what):
        """The branches an oracle run must take: a cycle accepted in
        full (a verify pass straight after a verify pass), a replay after
        a partial acceptance (2 positions or more) and one of 3 or more
        (kernel 2 on a replay)."""
        verify = [i for i, L in enumerate(lengths) if i and L == gamma + 1]
        replays = [L for i, L in enumerate(lengths) if i and L <= gamma]
        full = sum(i + 1 in verify for i in verify) + (
            lengths[-1] == gamma + 1)
        check(stats.accepted > 0 and full > 0 and max(replays) >= 3,
              f'{what}: the oracle schedule did not run its branches '
              f'(lengths {lengths})')
        return full, collections.Counter(replays)

    def spec_launches(lengths, quantized=False, int4=False, layers=32,
                      attn=3):
        """The launches a run of calls of these lengths makes (a model of
        `layers` layers, `attn` of them attention)."""
        n_calls = len(lengths)
        want = collections.Counter({
            'rmsnorm': (2 * layers + 1) * n_calls, 'flash_attention': attn,
            'fir_gate': (layers - attn) * sum(L >= 3 for L in lengths)})
        rows = (attention_buffer_mod.SPLIT_MAX_ROWS if quantized
                else attention_buffer_mod.SPLIT_MAX_ROWS_BF16)
        want['flash_attention_buffer_q8' if quantized
             else 'flash_attention_buffer'] = attn * (n_calls - 1)
        want['combine_partials'] = attn * sum(L <= rows for L in lengths[1:])
        if int4:
            want['int4_matmul'] = 5 * layers * sum(L <= 128 for L in lengths)
        return {k: v for k, v in want.items() if v}

    def spec_teacher_forced(model, prompt, toks, logps):
        """(mean and max |log-prob - forward's|, the one-rounding
        yardstick's mean (median of the four draws), greedy argmax
        agreement) for one run."""
        P = len(prompt)
        full = torch.as_tensor(np.concatenate([tok.tokenize(prompt), toks]),
                               device=dev).long()[None]
        nxt = full[0, P:]
        ref = torch.log_softmax(model(full)[0][0, P - 1:-1].float(), -1)
        nud = torch.log_softmax(nudged_forward(model, full)[0, P - 1:-1]
                                .float(), -1)
        lp_ref = ref.gather(-1, nxt[:, None])[:, 0]
        d = (torch.as_tensor(logps, device=dev) - lp_ref).abs()
        lp = torch.log_softmax(nudged_draws(model, full)[
            :, 0, P - 1:-1].float(), -1).gather(
                -1, nxt[None, :, None].expand(5, -1, 1))[..., 0]
        f = median_yardstick(
            'speculative log-probs', float(d.mean()),
            [float((lp[k] - lp[0]).abs().mean()) for k in range(1, 5)],
            float((nud.gather(-1, nxt[:, None])[:, 0] - lp_ref).abs()
                  .mean()))
        return (float(d.mean()), float(d.max()), f,
                float((ref.argmax(-1) == nxt).float().mean()))

    tok = evo.tokenizer
    n18, g18 = 32, 8
    spec_run(evo.model, prompts18['non-repetitive'][:200], 12, g18)  # warm
    generate([prompts18['non-repetitive'][:200]], evo.model, tok,
             n_tokens=4, verbose=0)
    spec18 = {}
    greedy_s = {}

    def greedy_run(prompt):
        torch.cuda.synchronize()
        t = time.time()
        seqs_, _ = generate([prompt], evo.model, tok, n_tokens=n18,
                            verbose=0)
        return seqs_[0], time.time() - t

    for label, spec_first in (('repetitive', False),
                              ('non-repetitive', True)):
        prompt = prompts18[label]
        if spec_first:
            runs = spec_run(evo.model, prompt, n18, g18)
        gseq, greedy_s[label] = greedy_run(prompt)
        if not spec_first:
            runs = spec_run(evo.model, prompt, n18, g18)
        toks, logps, stats, secs, counts, lengths = runs
        launches[f'speculative_8k_{label}'] = counts
        want18 = spec_launches(lengths)
        check(counts == want18, f'speculative launches {counts}, expected '
              f'{want18}')
        check(len(toks) == n18 and len(logps) == n18, 'speculative length')
        d18, dmax18, f18, agree18 = spec_teacher_forced(evo.model, prompt,
                                                        toks, logps)
        spec18[label] = dict(
            seconds=secs, tokens_per_s=n18 / secs,
            greedy_seconds=greedy_s[label],
            greedy_tokens_per_s=n18 / greedy_s[label],
            acceptance=stats.acceptance_rate,
            tokens_per_call=stats.tokens_per_call,
            stats=dataclasses.asdict(stats), calls_of_3_or_more=sum(
                L >= 3 for L in lengths),
            same_tokens_as_greedy=float(np.mean(
                np.asarray(list(gseq)) ==
                np.asarray(list(tok.detokenize(toks.tolist()))))),
            teacher_forcing=dict(mean_abs=d18, max_abs=dmax18,
                                 yardstick=f18, argmax_agreement=agree18))
        log(f'   {label} 512 nt + {n18}, g = {g18}: speculative {secs:.3f} s '
            f'({n18 / secs:.1f} tokens/s), greedy generate '
            f'{greedy_s[label]:.3f} s ({n18 / greedy_s[label]:.1f} tokens/s); '
            f'acceptance {stats.acceptance_rate:.3f}, '
            f'{stats.tokens_per_call:.2f} tokens a device call, {stats}; '
            f'launches {counts}; teacher forcing: mean abs log-prob diff '
            f'{d18:.5f} (max {dmax18:.4f}), one rounding step {f18:.5f} '
            f'(limit 1x), argmax agreement {agree18:.4f} (limit 0.75)')
        check(d18 <= f18 and agree18 >= 0.75,
              f'speculative log-probs disagree with teacher forcing '
              f'({label})')

    def oracle_run(model, prompt, n, gamma, schedule, what, **kw):
        """A run with `OracleDrafter` (the greedy continuation, made wrong
        at set places), held to the launch counts of its schedule, to its
        branches and to teacher forcing."""
        oracle = OracleDrafter(model, tok, len(prompt), schedule)
        toks, logps, stats, secs, counts, lengths = spec_run(
            model, prompt, n, gamma, oracle)
        want = spec_launches(lengths, **kw)
        check(counts == want, f'{what} launches {counts}, expected {want}')
        check(len(toks) == n and len(logps) == n, f'{what} length')
        full, replays = check_schedule_ran(lengths, gamma, stats, what)
        d, dmax, f, agree = spec_teacher_forced(model, prompt, toks, logps)
        res = dict(
            seconds=secs, tokens_per_s=n / secs, oracle_seconds=oracle.seconds,
            oracle_anchors=oracle.anchors, schedule=schedule,
            acceptance=stats.acceptance_rate,
            tokens_per_call=stats.tokens_per_call,
            stats=dataclasses.asdict(stats), full_cycles=full,
            replays_by_length=dict(sorted(replays.items())),
            teacher_forcing=dict(mean_abs=d, max_abs=dmax, yardstick=f,
                                 argmax_agreement=agree))
        log(f'   {what}, oracle drafter (schedule {schedule}), {n} tokens: '
            f'{secs:.3f} s without the drafter\'s {oracle.seconds:.3f} s '
            f'({n / secs:.1f} tokens/s; {oracle.anchors} greedy '
            f'continuations); acceptance {stats.acceptance_rate:.3f}, '
            f'{stats.tokens_per_call:.2f} tokens a device call, {stats}; '
            f'{full} cycles accepted in full, replays by length '
            f'{res["replays_by_length"]}; launches {counts}; teacher '
            f'forcing: mean abs log-prob diff {d:.5f} (max {dmax:.4f}), one '
            f'rounding step {f:.5f} (limit 1x), argmax agreement '
            f'{agree:.4f} (limit 0.75)')
        check(d <= f and agree >= 0.75,
              f'{what}: oracle-drafted log-probs disagree with teacher '
              f'forcing')
        return res, counts

    # the branches that acceptance 0 never takes: a cycle accepted in
    # full keeps the verified cache, a partial one restores the saved
    # state and replays 3-6 positions (kernel 2 on a replay)
    spec18['oracle'], launches['speculative_8k_oracle'] = oracle_run(
        evo.model, prompts18['non-repetitive'], 64, g18,
        [8, 8, 5, 8, 2, 0, 8, 3], f'bf16, g = {g18}')

    # one verify pass (9 positions at offset 512) and one decode step,
    # restoring the cache between calls; and a verify pass in the
    # profiler, for its device time
    ids18 = np.asarray(tok.tokenize(prompts18['repetitive']))[None]
    cache18 = evo.model.initialize_inference_params(1, 512 + n18 + g18 + 2)
    _, cache18 = evo.model(ids18, inference_params_dict=cache18,
                           donate_cache=True, resume=False)
    saved18 = (cache18['offset'], list(cache18['layers']))
    x18 = ids18[:, :g18 + 1]

    def restored():
        cache18['offset'], cache18['layers'] = saved18[0], list(saved18[1])
        return cache18

    verify_ms = time_ms(torch, lambda: evo.model(
        x18, inference_params_dict=restored(), donate_cache=False,
        resume=True), reps=10, warmup=2)
    tok18 = torch.as_tensor(x18[:, 0], device=dev).long()
    step_ms = time_ms(torch, lambda: model_lib.decode_step(
        evo.model.module, tok18, restored()), reps=10, warmup=2)
    from torch.profiler import ProfilerActivity, profile
    restored()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof18:
        t = time.time()
        evo.model(x18, inference_params_dict=cache18, donate_cache=False,
                  resume=True)
        torch.cuda.synchronize()
        verify_wall = 1e3 * (time.time() - t)
    verify_busy = sum(e.self_device_time_total for e in prof18.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, 'is_user_annotation', False)) / 1e3
    del cache18, saved18
    log(f'   one verify pass (9 positions at offset 512): {verify_ms:.2f} ms '
        f'(CUDA events; device busy {verify_busy:.2f} ms of '
        f'{verify_wall:.2f} ms in the profiler), one decode step '
        f'{step_ms:.2f} ms: at full acceptance a verify pass would emit '
        f'{(g18 + 1) / verify_ms * 1e3:.1f} tokens/s, a decode step '
        f'{1e3 / step_ms:.1f}')
    spec18['verify_pass'] = dict(
        ms=verify_ms, device_busy_ms=verify_busy,
        profiled_wall_ms=verify_wall, decode_step_ms=step_ms,
        tokens_per_s_at_full_acceptance=(g18 + 1) / verify_ms * 1e3)

    # Kernels 4, 5 and 8 at the shapes a verify pass gives them, against
    # their plain versions (limits as in phase 2) and timed by graph
    # replay over buffers larger together than L2, beside the bound and
    # the library call.
    def spec_buffers(Lq, offset):
        """Sets of buffers (q, bf16 k, v, int8 k, v, scales) of length
        offset + 16, as many as 110 MB of live keys and values take."""
        T = offset + 16
        n = int(110e6 // (2 * (offset + Lq) * H * Dh * 2)) + 1
        return [buffers(1, Lq, T, offset) for _ in range(n)]

    spec_k4, spec_k5 = {}, {}
    err18 = {'flash_attention_buffer': 0.0, 'flash_attention_buffer_q8': 0.0}
    for Lq in (4, 9):
        for offset in (512, 8000):
            sets = spec_buffers(Lq, offset)
            q, _off, bf, i8, sc = sets[0]
            err18['flash_attention_buffer'] = max(
                err18['flash_attention_buffer'], scaled_err(
                    flash_attention_buffer(q, *bf, offset),
                    attention_buffer_plain(q, *bf, offset)))
            err18['flash_attention_buffer_q8'] = max(
                err18['flash_attention_buffer_q8'], scaled_err(
                    flash_attention_buffer(q, *i8, offset, *sc),
                    attention_buffer_plain(q, *i8, offset, *sc)))
            flops = attention_flops(H, Dh, Lq, [offset])
            qo = 2 * Lq * H * Dh * 2
            key = f'Lq={Lq} offset={offset}'
            if Lq == 9:
                spec_k4[key] = dict(
                    ms=time_graph_ms(torch, [
                        (lambda s=s: flash_attention_buffer(
                            s[0], *s[2], offset)) for s in sets]),
                    plain_ms=time_ms(torch, lambda: attention_buffer_plain(
                        q, *bf, offset), reps=3, warmup=1),
                    bound_ms=1e3 * max(
                        (qo + 2 * (offset + Lq) * H * Dh * 2)
                        / peak['bytes_s'], flops / peak['bf16']),
                    library_ms=graph_or_events_ms(torch, [
                        (lambda s=s: sdpa_over_live_prefix(
                            s[0], *s[2], offset)) for s in sets]))
            spec_k5[key] = dict(
                ms=time_graph_ms(torch, [
                    (lambda s=s: flash_attention_buffer(
                        s[0], *s[3], offset, *s[4])) for s in sets]),
                plain_ms=time_ms(torch, lambda: attention_buffer_plain(
                    q, *i8, offset, *sc), reps=3, warmup=1),
                bound_ms=decode8_bound_ms(offset, Lq),
                design=('split + combine'
                        if Lq <= attention_buffer_mod.SPLIT_MAX_ROWS
                        else 'mainloop'))
            del sets, q, bf, i8, sc
    int4_err18 = 0.0
    for M in (4, 9):
        for K, Kp, N in layer_calls:
            x, packed, sc = int4_case(M, Kp, N)
            x = x[:, :K].contiguous()
            int4_err18 = max(int4_err18, scaled_err(
                int4_matmul(x, packed, sc), int4_matmul_plain(x, packed, sc)))
    spec_k8 = {9: int4_times(9, 4096, 4096, 12288, plain=True)}
    log(f'   kernel 4 at a verify pass (graph replay): {spec_k4}; kernel 5: '
        f'{spec_k5}; kernel 8 at M=9, 4096 x 12288: {spec_k8}; scaled '
        f'errors against the plain versions: {err18}, kernel 8 '
        f'{int4_err18:.3e}')
    check(max(err18.values()) <= 2 ** -5 and int4_err18 <= 1e-4,
          f'a kernel disagrees at the verify shapes: {err18}, {int4_err18}')
    kernels['flash_attention_buffer']['speculative'] = spec_k4
    kernels['flash_attention_buffer_q8']['speculative'] = spec_k5
    kernels['int4_matmul']['speculative'] = spec_k8

    # the port's native FASTA scanner builds here and reads as the
    # Python parser does
    check(fastio.available(), 'the native FASTA scanner did not build')
    fasta_path = os.path.join(ROOT, 'examples', 'example_seqs.fasta')
    with open(fasta_path) as f:
        check(fasta_mod.read_fasta(fasta_path) == tuple(
            map(list, zip(*fasta_mod.iter_fasta(f)))), 'fastio disagrees')
    log(f'   fastio: {fastio.library_path().name} built and read '
        f'{fasta_path} as the Python parser does')

    # -- 19. training: kernels 1-3 under autograd, LoRA at full depth ------
    # -- 20. full fine-tuning of 9 layers at full width ----------------------
    corpus_dir = tempfile.mkdtemp(prefix='evo_train_')
    cp_dir = tempfile.mkdtemp(prefix='evo_cp_')
    try:
        corpus = train_corpus(np, corpus_dir)
        # phase 21's and 22's references, before phase 19 trains this
        # model
        ref21 = phase21_inputs(torch, np, evo, prompts, seqs,
                               nudged_forward, corpus_dir)
        phase22_inputs(torch, evo, prompts, nudged_forward, cp_dir,
                       os.path.join(corpus_dir, 'model_in.pt'))
        # -- 23. serving, speculation and LoRA under a mesh, 2 ranks -----
        # beside the unchanged single-process model; (c)'s checks wait for
        # phase 20's loss
        t23 = time.time()
        mesh_dir = os.path.join(corpus_dir, 'mesh')
        os.makedirs(os.path.join(mesh_dir, 'f'))
        inp23 = phase23_inputs(torch, np, mesh_dir, corpus,
                               prompts18['non-repetitive'])
        res23 = phase23_mesh(
            np, smi, launches, evo.model, evo.tokenizer, inp23, mesh_dir,
            dict(teacher_forced=teacher_forced, spec_launches=spec_launches,
                 check_schedule_ran=check_schedule_ran,
                 spec_teacher_forced=spec_teacher_forced))
        res23['f'] = phase23_cli(torch, np, inp23, res23,
                                 os.path.join(mesh_dir, 'f'))
        f23 = res23['f']
        log(f'   phase 23 seconds: {time.time() - t23:.1f} (ranks '
            f'{res23["seconds"]:.1f}, CLI {f23["seconds"]:.1f}, the one '
            f'process beside it {f23["one_process_seconds"]:.1f})')
        torch.cuda.empty_cache()
        log(f'== 19. gradients through kernels 1-3 ({smi})')
        check_kernel_grads(torch, np, kernels, smi)
        res19 = phase19_lora(torch, np, evo, smi, launches, nudged_forward,
                             corpus)
        del evo
        torch.cuda.empty_cache()
        res20 = phase20_full(torch, np, smi, launches, corpus)
        phase23_lora_check(res23, res20)
        # -- 25. LoRA over a quantized base, mixed types ------------------
        torch.cuda.empty_cache()
        phase25_quant_lora_mixed(torch, np, smi, launches, res19, res20,
                                 corpus)
        # -- 21. data- and tensor-parallel execution, 2 ranks ------------
        torch.cuda.empty_cache()
        phase21_parallel(torch, np, smi, launches, ref21, res20, corpus,
                         corpus_dir)
        # -- 24. training under context parallelism, 2 ranks -------------
        torch.cuda.empty_cache()
        phase24_cp_training(torch, np, smi, launches, kernels, res20,
                            corpus, os.path.join(corpus_dir, 'cp_train'))
    finally:
        shutil.rmtree(corpus_dir, ignore_errors=True)

    # -- 6. segmented scoring, evo-1-131k-base at full width ----------------
    t0 = time.time()
    evo = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda')
    model, tok = evo.model, evo.tokenizer
    torch.cuda.synchronize()
    log(f'== 6. evo-1-131k-base random init: {model.num_params:,} parameters '
        f'in {time.time() - t0:.1f} s')
    # -- 22. context parallelism, 2 ranks (beside this model) --------------
    try:
        phase22_context_parallel(torch, np, smi, launches, ref21, model, tok,
                                 cp_dir)
    finally:
        shutil.rmtree(cp_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # (a) 12,000 nt in one pass and in segments of 4,096. The segments run
    # the same layers on other shapes (other GEMM tiles, the conv's chunks
    # aligned elsewhere, the buffer kernel for the causal one), so their
    # bf16 activations round in other places. The yardstick is again one
    # extra bf16 rounding at layer 0: a segmented score may differ from
    # the one-pass score by no more than that rounding moves a position's
    # log-likelihood on average, and likewise the entropies. A fault (a
    # lost state, a wrong offset) moves them by their own spread.
    seq = ''.join(rng.choice(list('ACGT'), 12000))
    ids12k = prepare_batch([seq], tok)[0]
    ref, _ = model(ids12k)
    nudged = nudged_forward(model, ids12k)
    lp_ref = logits_to_logprobs(ref, ids12k)
    lp_floor = float((logits_to_logprobs(nudged, ids12k) - lp_ref).abs()
                     .mean())

    def entropy(logits):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)

    ent_floor = float((entropy(nudged) - entropy(ref)).abs().mean())
    del ref, nudged
    one_pass = score_sequences([seq], model, tok)[0]
    ent_one = positional_entropies([seq], model, tok)[0]
    _build.LAUNCHES.clear()
    segmented = score_sequences_segmented([seq], model, tok,
                                          segment_len=4096)[0]
    launches['score_segmented_12k'] = dict(_build.LAUNCHES)
    ent_seg = positional_entropies_segmented([seq], model, tok,
                                             segment_len=4096)[0]
    ent_diff = float(np.abs(ent_seg - ent_one).mean())
    log(f'   12,000 nt: score one pass {one_pass:.6f}, in segments of 4,096 '
        f'{segmented:.6f} (difference {abs(segmented - one_pass):.3e}; one '
        f'rounding step at layer 0 moves a log-likelihood by '
        f'{lp_floor:.3e} on average); entropies differ by {ent_diff:.3e} on '
        f'average (one rounding step: {ent_floor:.3e}); launches '
        f'{launches["score_segmented_12k"]}')
    # 12,001 tokens: segments of 3,809 + 4,096 + 4,096
    check(launches['score_segmented_12k'] == {
        'rmsnorm': 3 * 65, 'fir_gate': 3 * 29, 'flash_attention': 3,
        'flash_attention_buffer': 2 * 3},
        f'launches {launches["score_segmented_12k"]}')
    check(abs(segmented - one_pass) <= lp_floor and ent_diff <= ent_floor
          and len(ent_seg) == 12000, 'segmented scoring disagrees')

    # (b) 131,072 nt (131,073 tokens with the BOS) in segments of 8,192:
    # a first segment of 8,193 and 15 of 8,192
    long_seq = ''.join(rng.choice(list('ACGT'), 131072))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    _build.LAUNCHES.clear()
    t0 = time.time()
    long_score = score_sequences_segmented([long_seq], model, tok,
                                           segment_len=8192)[0]
    long_s = time.time() - t0
    long_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches['score_segmented_131k'] = dict(_build.LAUNCHES)
    log(f'   131,072 nt in 16 segments: score {long_score:.6f} in '
        f'{long_s:.2f} s ({131072 / long_s:.0f} nt/s); peak '
        f'{long_peak_gib:.2f} GiB ('
        f'{base_gib:.2f} GiB of weights before); launches '
        f'{launches["score_segmented_131k"]}')
    check(np.isfinite(long_score) and long_score < 0, f'score {long_score}')
    check(launches['score_segmented_131k'] == {
        'rmsnorm': 16 * 65, 'fir_gate': 16 * 29, 'flash_attention': 3,
        'flash_attention_buffer': 15 * 3},
        f'launches {launches["score_segmented_131k"]}')

    # -- 14. the fused-mixer configuration, evo-1-131k-base ------------------
    # The segmented scorer puts the ragged remainder first: that segment
    # falls through to the unfused kernels, and every later one (a multiple
    # of the chunk) takes the fused kernel with the carried state. The
    # counts are worked out from the bounds.
    fused131 = Evo('evo-1-131k-base', random_init=True, seed=0,
                   device='cuda',
                   config_overrides=dict(hyena_fused_mixer=True)).model

    def expect_segmented(n_tokens, segment_len):
        bounds = _segment_bounds(n_tokens, segment_len)
        lens = [e - s for s, e in zip(bounds[:-1], bounds[1:])]
        fused = [L >= 3 and L % min(64, L) == 0 for L in lens]
        want = {'rmsnorm': 65 * len(lens), 'flash_attention': 3,
                'hyena_mixer': 29 * sum(fused),
                'fir_gate': 29 * (len(lens) - sum(fused)),
                'flash_attention_buffer': 3 * (len(lens) - 1)}
        return lens, {k: v for k, v in want.items() if v}

    _build.LAUNCHES.clear()
    one_pass_f = score_sequences([seq], fused131, tok)[0]
    launches['fused_score_12k_one_pass'] = dict(_build.LAUNCHES)
    check(launches['fused_score_12k_one_pass'] == expect_fused(12001),
          f'launches {launches["fused_score_12k_one_pass"]}')
    lens, want = expect_segmented(12001, 4096)
    _build.LAUNCHES.clear()
    segmented_f = score_sequences_segmented([seq], fused131, tok,
                                            segment_len=4096)[0]
    launches['fused_score_segmented_12k'] = dict(_build.LAUNCHES)
    ent_seg_f = positional_entropies_segmented([seq], fused131, tok,
                                               segment_len=4096)[0]
    ent_diff_f = float(np.abs(ent_seg_f - ent_one).mean())
    log(f'== 14. evo-1-131k-base with hyena_fused_mixer=True, 12,000 nt: '
        f'one pass {one_pass_f:.6f} (12,001 tokens fall through; unfused '
        f'{one_pass:.6f}); segments of {lens} {segmented_f:.6f} (difference '
        f'from the unfused one pass {abs(segmented_f - one_pass):.3e}, one '
        f'rounding step {lp_floor:.3e}); entropies differ by '
        f'{ent_diff_f:.3e} on average (one rounding step: {ent_floor:.3e}); '
        f'launches {launches["fused_score_segmented_12k"]}')
    check(launches['fused_score_segmented_12k'] == want
          and want['hyena_mixer'] == 29 * 2 and want['fir_gate'] == 29,
          f'launches {launches["fused_score_segmented_12k"]}, expected '
          f'{want}')
    check(abs(one_pass_f - one_pass) <= lp_floor
          and abs(segmented_f - one_pass) <= lp_floor
          and ent_diff_f <= ent_floor,
          'fused segmented scoring disagrees with the unfused one pass')

    lens, want = expect_segmented(131073, 8192)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_f_gib = torch.cuda.memory_allocated() / 2**30
    _build.LAUNCHES.clear()
    t0 = time.time()
    long_score_f = score_sequences_segmented([long_seq], fused131, tok,
                                             segment_len=8192)[0]
    long_f_s = time.time() - t0
    peak_f_gib = torch.cuda.max_memory_allocated() / 2**30
    launches['fused_score_segmented_131k'] = dict(_build.LAUNCHES)
    log(f'   131,072 nt in {len(lens)} segments ({lens[0]} then '
        f'{len(lens) - 1} of {lens[-1]}): score {long_score_f:.6f} (unfused '
        f'{long_score:.6f}) in {long_f_s:.2f} s ({131072 / long_f_s:.0f} '
        f'nt/s; unfused {long_s:.2f} s); peak {peak_f_gib:.2f} GiB, '
        f'{peak_f_gib - base_f_gib:.2f} GiB above what was allocated before '
        f'(unfused: {long_peak_gib - base_gib:.2f} GiB above); launches '
        f'{launches["fused_score_segmented_131k"]}')
    check(launches['fused_score_segmented_131k'] == want
          and want['hyena_mixer'] == 29 * 15,
          f'launches {launches["fused_score_segmented_131k"]}, expected '
          f'{want}')
    check(np.isfinite(long_score_f)
          and abs(long_score_f - long_score) <= lp_floor,
          f'fused 131k score {long_score_f} against {long_score}')
    del fused131

    # -- 26 (c). the FFT backend on evo-1-131k-base, with the published
    # hyena_fft_chunk = 8,192: one forward of 32,768 positions (4 chunks
    # with the modal state carried between them) against the same forward
    # with the chunk at 0 (one FFT of 65,536) and against the matmul
    # backend, within the one-rounding yardstick; then 131,072 nt in
    # segments of 16,384 (every resumed segment two chunks from a carried
    # state) against the matmul backend's score within phase 6's drift,
    # with its time and peak memory
    t26c = time.time()
    evo_fft = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda',
                  config_overrides=dict(hyena_conv_backend='fft'))
    cfg_fft = evo_fft.config
    check(cfg_fft.hyena_fft_chunk == 8192,
          f'the 131k config reads its chunk: {cfg_fft.hyena_fft_chunk}')
    ids32k = torch.as_tensor(np.random.default_rng(26).integers(
        65, 85, (1, 32768)), device=dev)
    ref32, _ = model(ids32k)
    floor32 = float((nudged_forward(model, ids32k) - ref32).abs().mean())
    _build.LAUNCHES.clear()
    t0 = time.time()
    chunked32, _ = evo_fft.model(ids32k)
    torch.cuda.synchronize()
    chunked_s = time.time() - t0
    launches['fft_forward_32k'] = dict(_build.LAUNCHES)
    check(launches['fft_forward_32k'] == per_forward,
          f'launches {launches["fft_forward_32k"]}')
    t0 = time.time()
    mono32 = model_lib.forward(evo_fft.model.module, ids32k,
                               cfg_fft.replace(hyena_fft_chunk=0))
    torch.cuda.synchronize()
    mono_s = time.time() - t0
    d_mono = float((chunked32 - mono32).abs().mean())
    d_matmul = float((chunked32 - ref32).abs().mean())
    log(f'== 26 (c). evo-1-131k-base under the FFT backend, hyena_fft_chunk '
        f'8,192: forward B=1 L=32,768 {chunked_s:.3f} s chunked, '
        f'{mono_s:.3f} s with the chunk at 0; mean abs logit diff chunked '
        f'vs one FFT {d_mono:.5f}, vs the matmul backend {d_matmul:.5f}; '
        f'one rounding step at layer 0 moves them by mean {floor32:.5f}; '
        f'launches {launches["fft_forward_32k"]}')
    check(bool(torch.isfinite(chunked32).all()) and d_mono <= floor32
          and d_matmul <= floor32,
          'the chunked FFT forward disagrees with one FFT or the matmul '
          'backend')
    del ref32, chunked32, mono32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_fft_gib = torch.cuda.memory_allocated() / 2**30
    _build.LAUNCHES.clear()
    t0 = time.time()
    long_score_fft = score_sequences_segmented([long_seq], evo_fft.model,
                                               tok, segment_len=16384)[0]
    long_fft_s = time.time() - t0
    peak_fft_gib = torch.cuda.max_memory_allocated() / 2**30
    launches['fft_score_segmented_131k'] = dict(_build.LAUNCHES)
    bounds = _segment_bounds(131073, 16384)
    lens = [e - s for s, e in zip(bounds[:-1], bounds[1:])]
    log(f'   131,072 nt in segments {lens[0]}, then {len(lens) - 1} of '
        f'{lens[-1]}: score {long_score_fft:.6f} (matmul backend in '
        f'segments of 8,192: {long_score:.6f}, difference '
        f'{abs(long_score_fft - long_score):.3e}; one rounding step '
        f'{lp_floor:.3e}) in {long_fft_s:.2f} s ({131072 / long_fft_s:.0f} '
        f'nt/s; matmul {long_s:.2f} s); peak {peak_fft_gib:.2f} GiB, '
        f'{peak_fft_gib - base_fft_gib:.2f} GiB above what was allocated '
        f'before (matmul: {long_peak_gib - base_gib:.2f}); launches '
        f'{launches["fft_score_segmented_131k"]}')
    check(launches['fft_score_segmented_131k'] == {
        'rmsnorm': 65 * len(lens), 'fir_gate': 29 * len(lens),
        'flash_attention': 3, 'flash_attention_buffer': 3 * (len(lens) - 1)},
        f'launches {launches["fft_score_segmented_131k"]}')
    check(np.isfinite(long_score_fft)
          and abs(long_score_fft - long_score) <= lp_floor,
          f'FFT 131k score {long_score_fft} against {long_score}')
    del evo_fft
    res26.update(seconds_131k=time.time() - t26c, score_131k_s=long_fft_s,
                 peak_131k_gib=peak_fft_gib - base_fft_gib,
                 forward_32k_s=dict(chunked=chunked_s, one_fft=mono_s))
    log(f'   phase 26 took {res26["seconds_8k"]:.1f} + '
        f'{res26["seconds_131k"]:.1f} s: {json.dumps(res26)}')

    # -- 7. generation: segments, resumed calls, the int8 KV cache ---------
    # Free-running greedy generations part ways at the first near-tie
    # (random weights give flat logits), so logits are compared where the
    # inputs are the same by construction: the logits after the prompt
    # (prefill in segments against one pass), and the first logits of a
    # resumed call against the same step of one call. Yardstick as above.
    prompts = [''.join(rng.choice(list('ACGT'), 1024)) for _ in range(2)]
    prompt_ids = prepare_batch(prompts, tok, prepend_bos=False)[0]
    n_new, n_first = 16, 8

    def compare(label, got, want, floor, factor=1.0):
        d = float((got - want).abs().mean())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        log(f'   {label}: mean abs logit diff {d:.5f} (max '
            f'{float((got - want).abs().max()):.4f}), argmax agreement '
            f'{agree:.2f}; one rounding step at layer 0: {floor:.5f}, limit '
            f'{factor:g}x')
        check(d <= factor * floor, f'{label}: logits disagree')
        return d

    def generation_checks(model, label):
        """One call, the prompt in segments, and two resumed calls;
        returns (tokens, step logits of the one call, launches,
        seconds per decode step)."""
        gen = Generator(model, tok, top_k=1, temperature=0.0)
        gen.generate(input_ids=prompt_ids, num_tokens=2)     # warm-up
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        toks, steps, _ = gen.generate(input_ids=prompt_ids, num_tokens=n_new)
        torch.cuda.synchronize()
        gen_s = time.time() - t
        counts = dict(_build.LAUNCHES)
        _, seg_steps, _ = gen.generate(input_ids=prompt_ids, num_tokens=1,
                                       prefill_segment_len=256)
        first, first_steps, cache = gen.generate(input_ids=prompt_ids,
                                                 num_tokens=n_first)
        check(torch.equal(first, toks[:, :n_first])
              and torch.equal(first_steps, steps[:, :n_first]),
              f'{label}: a shorter call is not the start of a longer one')
        offset = cache['offset']
        _, resumed_steps, resumed = gen.generate(
            input_ids=first[:, -1:], num_tokens=2,
            inference_params_dict=cache)
        check(cache['offset'] == offset and resumed['offset'] == offset + 2,
              f'{label}: the resumed call moved the caller\'s cache')
        full = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(),
                          toks], dim=1)
        ref, _ = model(full)
        floors = (nudged_forward(model, full) - ref).abs().mean(-1).mean(0)
        at = 1023 + n_first
        compare(f'{label}: prefill in segments of 256 vs one pass',
                seg_steps[:, 0], steps[:, 0], float(floors[1023]))
        compare(f'{label}: resumed call vs one call', resumed_steps[:, 0],
                steps[:, n_first], float(floors[at]))
        return toks, steps, counts, gen_s, floors

    toks, steps, counts, gen_s, floors = generation_checks(
        model, 'bf16 cache')
    launches['generate_131k'] = counts
    check(counts == {'rmsnorm': 65 * n_new, 'fir_gate': 29,
                     'flash_attention': 3,
                     'flash_attention_buffer': 3 * (n_new - 1),
                     'combine_partials': 3 * (n_new - 1)},
          f'launches {counts}')
    log(f'== 7. generate 2 x 1024 nt + {n_new}, bf16 cache: {gen_s:.3f} s; '
        f'launches {counts}')

    evo8 = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda',
               config_overrides={'kv_quant': 'int8'})
    toks8, steps8, counts8, gen8_s, _ = generation_checks(
        evo8.model, 'int8 cache')
    launches['generate_int8'] = counts8
    # every decode step reads the cache through the int8 kernel's split
    # key range and the combine kernel, once per attention layer; the
    # fresh prefill attends its own unquantised k, v
    check(counts8 == {'rmsnorm': 65 * n_new, 'fir_gate': 29,
                      'flash_attention': 3,
                      'flash_attention_buffer_q8': 3 * (n_new - 1),
                      'combine_partials': 3 * (n_new - 1)},
          f'launches {counts8}')
    check(torch.equal(steps8[:, 0], steps[:, 0]),
          'a fresh prefill must not depend on the cache type')
    # The first decode step reads positions 0..1023 back from the cache.
    # int8 keeps 127 levels of a (position, head) row's largest value,
    # about five times the rounding noise of bf16 on such a row, but only
    # in the k and v of 3 layers, where the yardstick perturbs the whole
    # stream at layer 0: the limit is 4x the yardstick.
    compare('int8 cache vs bf16 cache, first decode step', steps8[:, 1],
            steps[:, 1], float(floors[1024]), factor=4.0)
    # decode steps are host-bound and vary from run to run: time the two
    # caches in turns (bf16, int8, int8, bf16)
    step_ms = [1e3 * prefill_and_decode(m, 16) / 16
               for m in (model, evo8.model, evo8.model, model)]
    log(f'   generate 2 x 1024 nt + {n_new}, int8 cache: {gen8_s:.3f} s; '
        f'launches {counts8}; ms per decode step after a 1,024-nt prompt, '
        f'in turns: bf16 {step_ms[0]:.2f}, int8 {step_ms[1]:.2f}, int8 '
        f'{step_ms[2]:.2f}, bf16 {step_ms[3]:.2f}')
    del evo8, toks8, steps8

    # -- 8. quantized weights at full width: int4 + the int8 KV cache ------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    evo4 = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda',
               config_overrides={'weight_quant': 'int4', 'kv_quant': 'int8'})
    torch.cuda.synchronize()
    log(f'== 8. evo-1-131k-base, int4 weights + int8 KV cache: made and '
        f'quantized in {time.time() - t0:.1f} s; '
        f'{(torch.cuda.memory_allocated() - base) / 1e9:.3f} GB allocated '
        f'for it ({torch.cuda.memory_allocated() / 1e9:.3f} GB in all), '
        f'quantized_bytes {quantized_bytes(evo4.model.module) / 1e9:.3f} GB, '
        f'against {quantized_bytes(model.module) / 1e9:.3f} GB in bf16')
    check(quantized_bytes(evo4.model.module) < 0.3 * quantized_bytes(
        model.module), 'int4 weights take more than 0.3 of the bf16 ones')
    prompt_ids = prompt_ids[:, :512]
    n_new = 16
    gen4 = Generator(evo4.model, tok, top_k=1, temperature=0.0)
    gen4.generate(input_ids=prompt_ids, num_tokens=2)         # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    cache4 = evo4.model.initialize_inference_params(2, 640)
    evo4.model(prompt_ids, inference_params_dict=cache4)
    check(_build.LAUNCHES['int4_matmul'] == 0,
          'a prefill of 1,024 rows must not take the int4 kernel')
    del cache4
    _build.LAUNCHES.clear()
    t0 = time.time()
    toks4, steps4, _ = gen4.generate(input_ids=prompt_ids, num_tokens=n_new)
    torch.cuda.synchronize()
    gen4_s = time.time() - t0
    launches['generate_int4'] = dict(_build.LAUNCHES)
    # five quantized projections in each of 32 layers, every decode step
    check(launches['generate_int4'] == {
        'rmsnorm': 65 * n_new, 'fir_gate': 29, 'flash_attention': 3,
        'flash_attention_buffer_q8': 3 * (n_new - 1),
        'combine_partials': 3 * (n_new - 1),
        'int4_matmul': 160 * (n_new - 1)},
        f'launches {launches["generate_int4"]}')
    # The seam under int4: prefill + decode logits against one forward
    # over prompt + generation. The forward's 1,054 rows take the
    # dequantized product, whose weights are rounded to bf16 after the
    # scale, where the decode steps scale each group's float32 sum: a
    # rounding of every weight on top of what phase 5 compares. Yardstick
    # and limits as there: the drift of one bf16 rounding step at layer
    # 0, and argmax agreement >= 0.75.
    full = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(),
                      toks4], dim=1)
    ref, _ = evo4.model(full)
    floor4 = (nudged_forward(evo4.model, full) - ref).abs()[
        :, 511:511 + n_new]
    ref = ref[:, 511:511 + n_new]
    diff = (steps4 - ref).abs()
    agree = float((steps4.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f'   generate 2 x 512 nt + {n_new} under int4: {gen4_s:.3f} s; '
        f'launches {launches["generate_int4"]}; seam: mean abs logit diff '
        f'{float(diff.mean()):.5f} (max {float(diff.max()):.4f}), argmax '
        f'agreement {agree:.4f}; one rounding step at layer 0 moves them '
        f'by mean {float(floor4.mean()):.5f}; limit 1x')
    check(bool(torch.isfinite(steps4).all())
          and float(diff.mean()) <= float(floor4.mean())
          and agree >= 0.75, 'int4 seam logits disagree')
    del ref, full, diff, floor4, toks4, steps4
    # decode steps of the three weight types, in turns (host-bound, so
    # they vary from run to run): bf16, int8, int4, int4, int8, bf16
    evo_i8 = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda',
                 config_overrides={'weight_quant': 'int8'})
    turns = (('bf16', model), ('int8', evo_i8.model), ('int4', evo4.model))
    step_ms = [(name, 1e3 * prefill_and_decode(m, 16) / 16)
               for name, m in turns + turns[::-1]]
    log('   ms per decode step at B=2 after a 512-nt prompt, in turns: '
        + ', '.join(f'{name} {ms:.2f}' for name, ms in step_ms)
        + ' (int4 with the int8 KV cache, the others with a bf16 one)')
    del evo_i8, turns

    # -- 17. serving under int4 weights and the int8 KV cache ---------------
    # The model of phase 8 behind `GenerationServer`: 2 slots, 3 ragged
    # greedy prompts (the third waits for a slot), 32 new tokens each,
    # decode chunks of 8 steps, each prompt prefilled in one pass (> 128
    # rows, so the dequantized product, not kernel 8). Every decode step
    # runs kernel 8 on the five quantized projections of 32 layers and
    # kernel 5's split + combine on the 3 attention layers at B=2 with
    # per-row device offsets.
    rng17 = np.random.default_rng(17)
    plens17 = [200, 520, 1100]
    prompts17 = [''.join(rng17.choice(list('ACGT'), n)) for n in plens17]

    def new_server17():
        return GenerationServer(evo4.model, tok, max_slots=2, max_len=2048,
                                steps_per_sync=8)

    warm = new_server17()
    warm.submit(prompt=prompts17[0], num_tokens=9)
    warm.run()
    del warm
    server17 = new_server17()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    chunk_events.clear()
    t0 = time.time()
    rids17 = {i: server17.submit(prompt=p, num_tokens=32)
              for i, p in enumerate(prompts17)}
    results17 = server17.run()
    torch.cuda.synchronize()
    serve17_s = time.time() - t0
    launches['serve_int4'] = dict(_build.LAUNCHES)
    chunk17_ms = [a.elapsed_time(b) for a, b in chunk_events]
    n_steps17 = 8 * len(chunk17_ms)
    want17 = {'rmsnorm': 65 * (n_steps17 + 3), 'fir_gate': 29 * 3,
              'flash_attention': 3 * 3, 'int4_matmul': 160 * n_steps17,
              'flash_attention_buffer_q8': 3 * n_steps17,
              'combine_partials': 3 * n_steps17}
    check(launches['serve_int4'] == want17,
          f'launches {launches["serve_int4"]}, expected {want17}')
    check(all(len(results17[r].token_ids) == 32 for r in rids17.values()),
          'a request of phase 17 did not end with its token count')
    d17, dmax17, f17, agree17 = teacher_forced(
        evo4.model, tok, prompts17, results17, rids17, list(rids17))
    log(f'== 17. serving, evo-1-131k-base int4 + int8 KV ({smi}): 3 '
        f'requests ({plens17} nt, 96 new tokens) on 2 slots: '
        f'{serve17_s:.3f} s, {96 / serve17_s:.1f} generated tokens/s; '
        f'{len(chunk17_ms)} chunks, median '
        f'{statistics.median(chunk17_ms) / 8:.2f} ms a step (CUDA events); '
        f'launches {launches["serve_int4"]}; teacher forcing: mean abs '
        f'log-prob diff {d17:.5f} (max {dmax17:.4f}), one rounding step '
        f'{f17:.5f} (limit 1x), argmax agreement {agree17:.4f} (limit '
        f'0.75)')
    check(d17 <= f17 and agree17 >= 0.75,
          'served int4 log-probs disagree with teacher forcing')
    # Kernel 5's split at one query row over this cache (B=2, T=2,048):
    # with device offsets the wrapper sizes the split over the whole
    # cache; with an int offset over the live prefix only.
    attn_idx = evo4.config.attn_layer_idxs[0]
    st17 = server17._cache['layers'][attn_idx]
    q17 = torch.randn((2, 1, 32, 128), device=dev, generator=g).bfloat16()
    k5 = {}
    for label, off, offs in (
            ('per-row (199, 1099)', torch.tensor([199, 1099],
                                                 dtype=torch.int32,
                                                 device=dev), (199, 1099)),
            ('device (1099, 1099)', torch.full((2,), 1099,
                                               dtype=torch.int32,
                                               device=dev), (1099, 1099)),
            ('int 1099', 1099, (1099, 1099)),
            ('device (199, 199)', torch.full((2,), 199, dtype=torch.int32,
                                             device=dev), (199, 199)),
            ('int 199', 199, (199, 199))):
        k5[label] = (time_graph_ms(torch, [lambda: flash_attention_buffer(
            q17, st17['k'], st17['v'], off, st17['ks'], st17['vs'])]),
            live_kv_bound_ms(peak, offs, True))
    log('   kernel 5 (split + combine) at one query row, B=2, T=2,048 (graph '
        'replay; bound by the live bytes): ' + ', '.join(
            f'{k} {v[0]:.4f} ms (bound {v[1]:.4f})' for k, v in k5.items()))
    del server17, results17, st17, q17

    # -- 17 (b). the serve CLI's server shape: 8 slots, int4 + int8 KV ------
    # `cli/serve.py`'s defaults (8 slots, max_len 8,192, decode chunks of
    # 32 steps, prompts filled in chunks of 128, fills of up to 8 batched)
    # over the model of phase 8: 8 greedy requests, prompts of 64-512 nt,
    # 16-24 new tokens each. Every decode step runs kernel 8 on the five
    # projections of 32 layers at M = 8 (the slot batch): the wgmma design;
    # the fills run it on chunks of up to 128 rows. The rows of each call
    # are recorded around the kernel's wrapper.
    rng17b = np.random.default_rng(171)
    plens17b = [64, 96, 150, 200, 256, 333, 420, 512]
    news17b = [int(n) for n in rng17b.integers(16, 25, len(plens17b))]
    prompts17b = [''.join(rng17b.choice(list('ACGT'), n)) for n in plens17b]
    rows17b = collections.Counter()
    real_k8 = int4_mod.int4_matmul_kernel

    def counted_k8(x, *a, **kw):
        rows17b[x.shape[0]] += 1
        return real_k8(x, *a, **kw)

    def new_server17b():
        return GenerationServer(evo4.model, tok, max_slots=8, max_len=8192,
                                steps_per_sync=32, prompt_chunk=128,
                                prefill_batch=8)

    warm = new_server17b()
    for p17 in prompts17b[:2]:
        warm.submit(prompt=p17, num_tokens=9)
    warm.run()
    del warm
    server17b = new_server17b()
    int4_mod.int4_matmul_kernel = counted_k8
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    chunk_events.clear()
    t0 = time.time()
    rids17b = {i: server17b.submit(prompt=p17, num_tokens=news17b[i])
               for i, p17 in enumerate(prompts17b)}
    results17b = server17b.run()
    torch.cuda.synchronize()
    serve17b_s = time.time() - t0
    launches['serve_int4_8_slots'] = dict(_build.LAUNCHES)
    rows_run17b = dict(rows17b)
    chunk17b_ms = [a.elapsed_time(b) for a, b in chunk_events]
    steps17b = 32 * len(chunk17b_ms)
    check(all(len(results17b[r].token_ids) == news17b[i]
              for i, r in rids17b.items()),
          'a request of phase 17 (b) did not end with its token count')
    # decode: 160 calls a step at the slot batch's 8 rows; fills: chunks
    # and tails of at most 128 rows; nothing else calls kernel 8
    check(rows17b[8] == 160 * steps17b
          and sum(rows17b.values()) == launches['serve_int4_8_slots'][
              'int4_matmul']
          and max(rows17b) <= 128,
          f'kernel 8 rows {rows_run17b} for {steps17b} decode steps')
    d17b, dmax17b, f17b, agree17b = teacher_forced(
        evo4.model, tok, prompts17b, results17b, rids17b, list(rids17b))
    check(d17b <= f17b and agree17b >= 0.75,
          'served int4 log-probs (8 slots) disagree with teacher forcing')
    # one step() that is a decode chunk alone (its requests admitted and
    # filled the step before), in the profiler: device ms a step, the idle
    # share, and kernel 8's calls by rows
    for i in range(8):
        server17b.submit(prompt=prompts17b[7][64 * i % 448:][:64],
                         num_tokens=40)
    server17b.step()
    check(server17b._fill is None and not server17b._queue
          and all(r is not None for r in server17b._slots),
          'the profiled step of phase 17 (b) would run a fill')
    from torch.profiler import ProfilerActivity, profile
    rows17b.clear()
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof17b:
        t = time.time()
        server17b.step()
        torch.cuda.synchronize()
        wall17b_ms = 1e3 * (time.time() - t)
    int4_mod.int4_matmul_kernel = real_k8
    ops17b = [e for e in prof17b.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy17b_ms = sum(e.self_device_time_total for e in ops17b) / 1e3
    k8_17b_ms = sum(e.self_device_time_total for e in ops17b
                    if 'int4_mma_kernel' in e.key) / 1e3
    check(dict(rows17b) == {8: 160 * 32}
          and _build.LAUNCHES['int4_matmul'] == 160 * 32,
          f'the profiled decode chunk ran kernel 8 at rows {dict(rows17b)}')
    server17b.run()
    res17b = dict(
        seconds=serve17b_s, tokens=sum(news17b),
        tokens_per_s=sum(news17b) / serve17b_s,
        chunk_ms=chunk17b_ms, step_ms=statistics.median(chunk17b_ms) / 32,
        kernel8_rows=rows_run17b,
        profiled_chunk=dict(device_ms_a_step=busy17b_ms / 32,
                            kernel8_ms_a_step=k8_17b_ms / 32,
                            wall_ms_a_step=wall17b_ms / 32,
                            idle_share=1 - busy17b_ms / wall17b_ms),
        teacher_forcing=dict(mean_abs=d17b, max_abs=dmax17b,
                             yardstick=f17b, argmax_agreement=agree17b))
    log(f'== 17 (b). serving at the serve CLI\'s shape, evo-1-131k-base int4 '
        f'+ int8 KV ({smi}): 8 requests ({plens17b} nt, {sum(news17b)} new '
        f'tokens) on 8 slots: {serve17b_s:.3f} s, '
        f'{sum(news17b) / serve17b_s:.1f} generated tokens/s; '
        f'{len(chunk17b_ms)} decode chunks of 32 steps, '
        f'{res17b["step_ms"]:.2f} ms a step (CUDA events); kernel 8 calls '
        f'by rows {rows_run17b}; launches {launches["serve_int4_8_slots"]}; '
        f'teacher forcing: mean abs log-prob diff {d17b:.5f} (max '
        f'{dmax17b:.4f}), one rounding step {f17b:.5f} (limit 1x), argmax '
        f'agreement {agree17b:.4f} (limit 0.75); profiled decode chunk: '
        f'device busy {busy17b_ms / 32:.3f} ms a step of '
        f'{wall17b_ms / 32:.2f} ms wall (idle share '
        f'{res17b["profiled_chunk"]["idle_share"]:.3f}), kernel 8 '
        f'{k8_17b_ms / 32:.3f} ms a step in 160 calls at M = 8')
    log(f'   phase 17 (b): {json.dumps(res17b)}')
    serving_mod._decode_chunk = real_chunk
    del server17b, results17b

    # -- 18 (continued). speculative decoding under int4 weights and the
    # int8 KV cache: the model of phase 8, 32 tokens from the repetitive
    # prompt at g = 3 (verify passes of 4 rows: kernel 5's split + combine
    # and kernel 8's wgmma design) and g = 8 (9 rows: kernel 5's mainloop
    # and kernel 8's wgmma design), launch counts from the run's schedule,
    # teacher forcing within phase 8's yardstick.
    spec_int4 = {}
    spec_run(evo4.model, prompts18['non-repetitive'][:200], 12, 8)  # warm
    for gamma in (3, 8):
        toks, logps, stats, secs, counts, lengths = spec_run(
            evo4.model, prompts18['repetitive'], 32, gamma)
        launches[f'speculative_int4_g{gamma}'] = counts
        want18 = spec_launches(lengths, quantized=True, int4=True)
        check(counts == want18, f'int4 speculative launches {counts}, '
              f'expected {want18}')
        # g = 3 verifies through the split, g = 8 through the mainloop
        check(counts['combine_partials'] > 0 if gamma == 3 else
              counts['flash_attention_buffer_q8']
              > counts.get('combine_partials', 0), f'lengths {lengths}')
        d18, dmax18, f18, agree18 = spec_teacher_forced(evo4.model,
                                                        prompts18['repetitive'],
                                                        toks, logps)
        spec_int4[gamma] = dict(
            seconds=secs, tokens_per_s=32 / secs,
            acceptance=stats.acceptance_rate,
            tokens_per_call=stats.tokens_per_call,
            stats=dataclasses.asdict(stats),
            teacher_forcing=dict(mean_abs=d18, max_abs=dmax18,
                                 yardstick=f18, argmax_agreement=agree18))
        log(f'== 18. speculative, evo-1-131k-base int4 + int8 KV, g = '
            f'{gamma}, 512 nt + 32: {secs:.3f} s ({32 / secs:.1f} tokens/s); '
            f'acceptance {stats.acceptance_rate:.3f}, '
            f'{stats.tokens_per_call:.2f} tokens a device call, {stats}; '
            f'launches {counts}; teacher forcing: mean abs log-prob diff '
            f'{d18:.5f} (max {dmax18:.4f}), one rounding step {f18:.5f} '
            f'(limit 1x), argmax agreement {agree18:.4f} (limit 0.75)')
        check(d18 <= f18 and agree18 >= 0.75,
              f'int4 speculative log-probs disagree (g = {gamma})')
    # one run with the oracle drafter at g = 8: full, partial and no
    # acceptance; replays of 1 and 3 positions (kernel 5's split; kernel
    # 8's streaming design at one row, its wgmma design at three) and of 6
    # and 7 (kernel 5's mainloop, kernel 8's wgmma design)
    res, counts = oracle_run(
        evo4.model, prompts18['non-repetitive'], 32, 8, [5, 8, 6, 2, 0, 8],
        'int4 + int8 KV, g = 8', quantized=True, int4=True)
    check(max(res['replays_by_length']) > attention_buffer_mod.SPLIT_MAX_ROWS
          and min(res['replays_by_length'])
          <= attention_buffer_mod.SPLIT_MAX_ROWS,
          f'the replays did not reach both designs of kernel 5: {res}')
    spec_int4['oracle'] = res
    launches['speculative_int4_oracle'] = counts
    spec18['int4_int8kv'] = spec_int4
    log(f'   phase 18 summary: {json.dumps(spec18)}')

    # -- 15. decode steps at long offsets, bf16 and int8 KV caches ----------
    # One evo-1-131k-base decode step at B=1 over a full 131,072-slot cache
    # of random finite values, at three offsets, through the card's route
    # (kernel 4, or kernel 5's split key range and the combine kernel, at
    # one query row) and through the dense plain route it replaced (float32
    # copies of the live bf16 prefix; the chunked plain version for int8),
    # in turns: new, plain, plain, new. Device ms is the profiler's sum of
    # kernel time of the step; peak is the allocation above what was held
    # before it.
    from evo_tpu_torch.layers import attention as attention_layer
    from torch.profiler import ProfilerActivity, profile

    def dense_route(q, k_buf, v_buf, off, ks=None, vs=None):
        if ks is None:
            return attention_layer.dense_step_attention(q, k_buf, v_buf, off)
        return attention_buffer_plain(q, k_buf, v_buf, off, ks, vs)

    def random_cache(kv_quant):
        cache = model_lib.init_cache(model.config.replace(kv_quant=kv_quant),
                                     1, 131072, 'cuda')
        for layer in cache['layers']:
            if isinstance(layer, dict):
                for name, t in layer.items():
                    if t.dtype == torch.int8:
                        t.random_(-127, 128, generator=g)
                    elif name in ('ks', 'vs'):
                        t.uniform_(0.005, 0.02, generator=g)
                    else:
                        t.normal_(generator=g)
        return cache

    def timed_step(cache, o, plain):
        cache['offset'] = o
        tok = torch.full((1,), 65, dtype=torch.long, device=dev)
        saved = attention_layer.flash_attention_buffer
        if plain:
            attention_layer.flash_attention_buffer = dense_route
        try:
            model_lib.decode_step(model.module, tok, cache)     # warm-up
            cache['offset'] = o
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            _build.LAUNCHES.clear()
            t = time.time()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                logits, _ = model_lib.decode_step(model.module, tok, cache)
                torch.cuda.synchronize()
            wall = 1e3 * (time.time() - t)
        finally:
            attention_layer.flash_attention_buffer = saved
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False)) / 1e3
        check(bool(torch.isfinite(logits).all()), 'decode step logits')
        return dict(device_ms=busy, wall_ms=wall,
                    peak_bytes=torch.cuda.max_memory_allocated() - held,
                    launches=dict(_build.LAUNCHES))

    log('== 15. decode steps at long offsets (evo-1-131k-base, B=1, a '
        '131,072-slot cache of random values)')
    long_decode = {}
    q1 = torch.randn((1, 1, 32, 128), device=dev, generator=g).bfloat16()
    for kv_quant in ('none', 'int8'):
        cache = random_cache(kv_quant)
        layer = next(t for t in cache['layers'] if isinstance(t, dict))
        bufs = [layer[n] for n in ('k', 'v', 'ks', 'vs') if n in layer]
        kernel = ({'flash_attention_buffer': 3, 'combine_partials': 3}
                  if kv_quant == 'none' else
                  {'flash_attention_buffer_q8': 3, 'combine_partials': 3})
        for o in (8191, 65535, 122879):
            turns = [timed_step(cache, o, plain)
                     for plain in (False, True, True, False)]
            for tr, plain in zip(turns, (False, True, True, False)):
                got = {k: tr['launches'].get(k, 0) for k in kernel}
                check(got == (dict.fromkeys(kernel, 0) if plain else kernel),
                      f'decode step launches {tr["launches"]}')
            new, old = turns[0::3], turns[1:3]
            long_decode[f'{kv_quant}@{o}'] = dict(
                new_device_ms=[t['device_ms'] for t in new],
                plain_device_ms=[t['device_ms'] for t in old],
                new_wall_ms=[t['wall_ms'] for t in new],
                plain_wall_ms=[t['wall_ms'] for t in old],
                new_peak_bytes=max(t['peak_bytes'] for t in new),
                plain_peak_bytes=max(t['peak_bytes'] for t in old))
            # the layer's kernel alone at this offset, as an int (the
            # split's count from the live prefix) and as a device tensor
            # (the serving path: the count from the buffer, each block's
            # range from the offset on the device), by graph replay
            for name, off in (
                    ('int', o),
                    ('device', torch.full((1,), o, dtype=torch.int32,
                                          device=dev))):
                long_decode[f'{kv_quant}@{o}'][f'kernel_ms_{name}_offset'] = \
                    time_graph_ms(torch, [
                        lambda: flash_attention_buffer(q1, bufs[0], bufs[1],
                                                       off, *bufs[2:])])
            log(f'   {"bf16" if kv_quant == "none" else "int8"} cache, '
                f'offset {o}: {long_decode[f"{kv_quant}@{o}"]}')
        del cache
        torch.cuda.empty_cache()
    gap = (long_decode['none@122879']['plain_peak_bytes']
           - long_decode['none@122879']['new_peak_bytes'])
    log(f'   bf16 step at offset 122,879: the dense route\'s peak is '
        f'{gap / 1e9:.3f} GB above the kernel route\'s')
    # the dense route's float32 copy of one layer's live k alone is
    # 122,880 x 32 x 128 x 4 bytes
    check(gap >= 122880 * 32 * 128 * 4, 'the bf16 decode step still copies')

    # -- 9. scoring under each quantized mode --------------------------------
    # The four ragged sequences of phase 4, same weights (seed 0) quantized,
    # against the bf16 scores of phase 4. A score is a mean over 1,000 to
    # 4,000 log-likelihoods, so the noise of quantization largely averages
    # out of it. Limits on |score - bf16 score|: 0.05 under int8 weights
    # (per-channel codes, about 0.4 % a product), 0.1 with int8
    # activations on top (one scale a token over 4,096 to 10,928 values is
    # coarser), 0.15 under int4 (about 10 % a product on Gaussian weights;
    # the JAX package's tests allow a mean logit drift of 0.15).
    log('== 9. scoring under each quantized mode, evo-1-8k-base, against '
        f'bf16 scores {scores}')
    for quant, limit in (('int8', 0.05), ('int8x8', 0.1), ('int4', 0.15)):
        evo_q = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda',
                    config_overrides=cli_quant_overrides(quant))
        _build.LAUNCHES.clear()
        t0 = time.time()
        scores_q = score_sequences(seqs, evo_q.model, evo_q.tokenizer)
        dt = time.time() - t0
        worst = max(abs(a - b) for a, b in zip(scores_q, scores))
        log(f'   {quant}: {scores_q} in {dt:.3f} s, largest difference '
            f'{worst:.4f} (limit {limit}); '
            f'{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated with '
            f'the bf16 131k model and the int4 one; launches '
            f'{dict(_build.LAUNCHES)}')
        check(all(np.isfinite(scores_q)) and worst <= limit,
              f'{quant} scores {scores_q} against {scores}')
        check(_build.LAUNCHES['int4_matmul'] == 0,
              'a scoring forward must not take the int4 kernel')
        del evo_q

    # -- 10. checkpoint round trip at full width, 8 layers deep -------------
    tmp = tempfile.mkdtemp(prefix='evo_snapshot_')
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        src = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda',
                  config_overrides=dict(num_layers=8, attn_layer_idxs=(7,),
                                        hyena_layer_idxs=()))
        want = score_sequences(seqs[:2], src.model, src.tokenizer)
        t0 = time.time()
        write_reference_snapshot(src.model.module, tmp, num_shards=4)
        write_s = time.time() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
        torch.cuda.synchronize()
        t0 = time.time()
        loaded = Evo('evo-1-8k-base', checkpoint_path=tmp, device='cuda')
        torch.cuda.synchronize()
        load_s = time.time() - t0
        got = score_sequences(seqs[:2], loaded.model, loaded.tokenizer)
        log(f'== 10. checkpoint round trip, 8 layers (7 Hyena, 1 attention) '
            f'at full width ({free_gb:.0f} GB free on disk): '
            f'{nbytes / 1e9:.2f} GB in {sorted(os.listdir(tmp))}; written '
            f'in {write_s:.1f} s ({nbytes / 1e9 / write_s:.2f} GB/s), '
            f'loaded in {load_s:.1f} s ({nbytes / 1e9 / load_s:.2f} GB/s); '
            f'scores {got} against {want}')
        check(loaded.config == src.config, 'the loaded config differs')
        check(got == want, 'scores after the round trip are not bit-equal')
        del src, loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 11. the command lines, each in a process of its own, the three
    # side by side ---------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='evo_cli_') as tmp:
        tsv = os.path.join(tmp, 'scores.tsv')
        reqs = os.path.join(tmp, 'requests.jsonl')
        outs = os.path.join(tmp, 'results.jsonl')
        with open(reqs, 'w') as f:
            for i, n in enumerate((64, 150, 300)):
                f.write(json.dumps({'id': f'r{i}',
                                    'prompt': 'ACGT' * (n // 4),
                                    'num_tokens': 16 + 8 * i}) + '\n')
        cmds = {
            'score': ['evo_tpu_torch.cli.score', '--input-fasta',
                      os.path.join(ROOT, 'examples', 'example_seqs.fasta'),
                      '--output-tsv', tsv, '--random-init', '--quant',
                      'int4'],
            'generate': ['evo_tpu_torch.cli.generate', '--random-init',
                         '--quant', 'int4', '--kv-quant', 'int8',
                         '--prompt', 'ACGT', '--n-tokens', '16',
                         '--temperature', '0', '--top-k', '1'],
            # the serve command line in JSONL mode on three requests
            'serve': ['evo_tpu_torch.cli.serve', '--random-init', '--quant',
                      'int4', '--requests-jsonl', reqs, '--output-jsonl',
                      outs, '--max-slots', '4', '--max-len', '1024']}
        procs, runs = {}, {}
        t0 = time.time()
        try:
            for label, cmd in cmds.items():
                with open(os.path.join(tmp, f'{label}.out'), 'w') as fo, \
                        open(os.path.join(tmp, f'{label}.err'), 'w') as fe:
                    procs[label] = subprocess.Popen(
                        [sys.executable, '-m'] + cmd, cwd=ROOT, stdout=fo,
                        stderr=fe)
            for label, proc in procs.items():
                rc = proc.wait(timeout=600)
                runs[label] = (rc, time.time() - t0, *(
                    open(os.path.join(tmp, f'{label}.{x}')).read()
                    for x in ('out', 'err')))
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for label, cmd in cmds.items():
            rc, secs, out, err = runs[label]
            log(f'== 11. python -m {cmd[0]} ...: exit code {rc} in '
                f'{secs:.1f} s (the three side by side); last lines: '
                f'{out.strip().splitlines()[-2:]}')
            check(rc == 0, f'{label} CLI failed:\n{err[-3000:]}')
        outs_g = [ln for ln in runs['generate'][2].splitlines()
                  if ln.startswith('Prompt: "ACGT",\tOutput: "')]
        check(len(outs_g) == 3 and len(set(outs_g)) == 1,
              f'generate CLI output: {runs["generate"][2][-2000:]}')
        with open(tsv) as f:
            rows = [ln.rstrip('\n').split('\t') for ln in f]
        check(rows[0] == ['seqs', 'scores'] and len(rows) == 4
              and all(len(r) == 2 and np.isfinite(float(r[1]))
                      and float(r[1]) < 0 for r in rows[1:]),
              f'score CLI TSV: {rows}')
        with open(outs) as f:
            lines = [json.loads(ln) for ln in f]
        log('   results: '
            f'{[(x["id"], x["num_tokens"], x["score"]) for x in lines]}')
        check([(x['id'], x['num_tokens']) for x in lines]
              == [('r0', 16), ('r1', 24), ('r2', 32)]
              and all(np.isfinite(x['score']) for x in lines),
              f'serve CLI output: {lines}')

    # -- 12. where the device time goes (checks nothing; last, so the
    # profiler's hooks cannot slow the timed phases) ----------------------
    def profile_window(label, fn, layout_ops=None):
        return profile_step(torch, label, fn, layout_ops)['layout']

    late_cache = model.initialize_inference_params(1, 132096)

    def late_segment():
        """The 16th segment of a 131k run: 8,192 tokens resumed at offset
        122,880 (the cache's earlier positions stay zeros: the work is the
        same)."""
        late_cache['offset'] = 122880
        model(ids, inference_params_dict=late_cache, resume=True)

    def decode_steps(m, n_steps):
        """A window of `n_steps` decode steps after a 512-nt prompt, whose
        prefill runs now, outside the window."""
        cache = m.initialize_inference_params(2, 640)
        logits, cache = m(prompt_ids, inference_params_dict=cache)
        state = [logits[:, -1].argmax(-1), cache]

        def run():
            for _ in range(n_steps):
                step, state[1] = model_lib.decode_step(m.module, state[0],
                                                       state[1])
                state[0] = step.argmax(-1)
        return run

    log('== 12. profiles (evo-1-131k-base)')
    shape_ops = (1, ids.shape[1], D)
    check(profile_window('one forward B=1 L=8192', lambda: model(ids),
                         shape_ops) == [0, 0],
          'the unfused forward still adds b_in over (B, L, 3, C) or copies '
          'it into (B, 3, C, L)')
    fused131 = Evo('evo-1-131k-base', random_init=True, seed=0,
                   device='cuda',
                   config_overrides=dict(hyena_fused_mixer=True)).model
    fused131(ids)
    # twice: the first window that meets a new kernel also pays for the
    # profiler's set-up of it
    profile_window('one forward B=1 L=8192 under hyena_fused_mixer (first '
                   'window)', lambda: fused131(ids))
    check(profile_window('one forward B=1 L=8192 under hyena_fused_mixer '
                         '(second window)', lambda: fused131(ids),
                         shape_ops) == [0, 0],
          'the fused forward still adds b_in over (B, L, 3, C) or copies '
          'it into (B, 3, C, L)')
    del fused131
    profile_window('prefill 2 x 512 + 8 decode steps',
                   lambda: prefill_and_decode(model, 8))
    late_segment()
    check(profile_window('one resumed segment B=1 L=8192 at offset 122,880',
                         late_segment, shape_ops) == [0, 0],
          'the resumed segment still adds b_in over (B, L, 3, C) or copies '
          'it into (B, 3, C, L)')
    del late_cache
    # one decode step: what it launches, and where an int4 step's time goes
    profile_window('4 decode steps at B=2, bf16 weights and cache (divide '
                   'by 4 for a step)', decode_steps(model, 4))
    profile_window('4 decode steps at B=2, int4 weights and int8 KV cache '
                   '(divide by 4 for a step)', decode_steps(evo4.model, 4))

    # the phase that stands for each kernel's main path
    main_phase = {'rmsnorm_w32': 'mixed_forward_8192',
                  'fir_gate_w32': 'mixed_forward_8192',
                  'hyena_mixer_w32': 'mixed_fused_forward_8192',
                  'int4_matmul_grad': 'lora_int4_128',
                  'int4_matmul_block': 'int4_block_call',
                  'int4_matmul_dots8': 'int4_dots8_call',
                  'flash_attention_buffer': 'score_segmented_131k',
                  'flash_attention_buffer_q8': 'generate_int8',
                  'combine_partials': 'generate_int8',
                  'int4_matmul': 'generate_int4',
                  'hyena_mixer': 'fused_forward_8192',
                  'modal_prefix': 'prefix_forward_8192',
                  'mlp_gate': 'mlp_gate_layer'}
    rows = []
    for kk in kernels.values():
        phase = main_phase.get(kk['name'], 'score_sequences')
        kk['launches'] = launches[phase][kk['name']]
        kk['launches_by_phase'] = {p: c.get(kk['name'], 0)
                                   for p, c in launches.items()}
        check(kk['launches'] > 0, f"{kk['name']} never ran in {phase}")
        rows.append(kk)
    log(f'   teacher-forcing yardsticks: {json.dumps(yardsticks)}')
    log(smi)
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
