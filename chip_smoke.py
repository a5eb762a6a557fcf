#!/usr/bin/env python3
"""Smoke run of the PyTorch port (evo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (built
for an H100: the kernels target sm_90a). It

  1. prints the card (nvidia-smi name and power limit) and the versions,
     and checks that float32 matmuls run in full float32 (no TF32);
  2. builds the three CUDA kernels from evo_tpu_torch/csrc and holds each
     against its plain PyTorch version at evo-1-8k-base's full-width
     shapes and at ragged ones, and times kernel, plain version, the
     roofline bound and a library yardstick with CUDA events;
  3. checks the whole port on a small bf16 model against the same model's
     plain PyTorch path on the CPU;
  4. scores with evo-1-8k-base at full width (32 layers, D=4096, random
     weights from a seed): 4 ragged sequences of 1,000-4,000 nt and one
     forward at B=1, L=8192, checking finite scores, padding invariance
     and the kernels' launch counts (65 / 29 / 3 per forward);
  5. generates greedily from 2 prompts of 512 nt, 64 new tokens, checking
     the launch counts and that prefill + decode logits agree with one
     forward over prompt + generation, and times prefill and decode steps;
  6. profiles one forward at B=1, L=8192 and a prefill with 8 decode
     steps, and prints the device's idle share and where its time goes.

Any failed check raises; nothing is caught. The last line of standard
output is {"ok": true, "device": {...}}; the line before it holds the
per-kernel numbers, and the one before that the card's name and power
limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet, dense): memory
# bytes/s, bf16 tensor-core FLOP/s and float32 (non-tensor) FLOP/s. The
# bounds hold for that card only; any other card name raises.
H100_SXM = dict(bytes_s=3.35e12, bf16=989e12, fp32=67e12)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def log(*a):
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

    from evo_tpu_torch import Evo, generate, score_sequences
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.ops.attention import (attention_plain,
                                             flash_attention_causal)
    from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
    from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain
    from evo_tpu_torch.scoring import prepare_batch

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
    for line in so.with_suffix('.log').read_text().splitlines():
        if 'registers' in line or 'spill' in line:
            log('   ptxas:', line.strip())
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

    # FIR + gate: the kernel repeats the plain version's fp32 arithmetic in
    # the same order without FMA contraction, so outputs should be bitwise
    # equal; required: max abs err <= 1e-2 and >= 99.9% of elements equal.
    err, worst_equal = 0.0, 1.0
    for B, L in ((1, 1), (1, 3), (1, 77), (2, 1000), (1, 1000), (1, 8192)):
        z, fw, fb = randn(B, 3, D, L), randn(3, D, 3), randn(3, D)
        for got, want in zip(fir_gate(z, fw, fb), fir_gate_plain(z, fw, fb)):
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            eq = float((got == want).float().mean())
            err, worst_equal = max(err, e), min(worst_equal, eq)
        log(f'   fir_gate B={B} L={L}: max abs err {e:.3e}, equal {eq:.6f}')
    check(err <= 1e-2 and worst_equal >= 0.999,
          f'fir_gate kernel disagrees: err {err}, equal {worst_equal}')
    z, fw, fb = randn(1, 3, D, 8192), randn(3, D, 3), randn(3, D)
    nbytes = (z.numel() + 2 * z.numel() // 3 + fw.numel() + fb.numel()) * 2
    kernels['fir_gate'] = dict(
        name='fir_gate', route='cuda', source='evo_tpu_torch/csrc/fir_gate.cu',
        replaces='evo_tpu/ops/pallas_fir.py:28', max_abs_err=err,
        bit_equal_fraction=worst_equal,
        ms=time_ms(torch, lambda: fir_gate(z, fw, fb)),
        plain_ms=time_ms(torch, lambda: fir_gate_plain(z, fw, fb)),
        # per (b, c, t): 3 streams x (3 mul + 3 add + bias) + 1 gate mul
        bound_ms=1e3 * max(nbytes / peak['bytes_s'],
                           22 * (z.numel() // 3) / peak['fp32']),
        bound_by='bytes', library_ms=None,
        shape='z (1, 3, 4096, 8192) bf16')

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
    for B, L in ((1, 1), (1, 63), (2, 1000), (1, 8192)):
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
    flops = 4 * H * Dh * L * (L + 1) // 2
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
    for kk in kernels.values():
        log(f"   {kk['name']}: {kk['ms']:.4f} ms (bound {kk['bound_ms']:.4f}"
            f" ms by {kk['bound_by']}, plain {kk['plain_ms']:.4f}, library "
            f"{kk['library_ms']})")
    del x, w, z, fw, fb, qkv, q, k, v, qt, kt, vt

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
    launches = {}

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
    want = {'rmsnorm': 65 * n_new, 'fir_gate': 29, 'flash_attention': 3}
    check(launches['generate'] == want, f'launches {launches["generate"]}')
    check(all(len(s) == n_new for s in out)
          and all(np.isfinite(gen_scores)), f'generation {gen_scores}')
    prompt_ids = prepare_batch(prompts, evo.tokenizer, prepend_bos=False)[0]
    module = evo.model.module

    def prefill_and_decode(n_steps):
        cache = evo.model.initialize_inference_params(2, 512 + n_steps + 1)
        logits, cache = evo.model(prompt_ids, inference_params_dict=cache)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(n_steps):
            step, cache = model_lib.decode_step(module, tok, cache)
            tok = step.argmax(-1)
        torch.cuda.synchronize()
        return time.time() - t

    t0 = time.time()
    decode_s = prefill_and_decode(32)
    prefill_s = time.time() - t0 - decode_s
    log(f'== 5. generate 2 x 512 nt + {n_new}: {gen_s:.3f} s '
        f'({2 * n_new / gen_s:.1f} tokens/s end to end); prefill '
        f'{prefill_s:.3f} s; decode {1e3 * decode_s / 32:.2f} ms per step, '
        f'{2 * 32 / decode_s:.1f} tokens/s; launches {launches["generate"]}')

    toks, step_logits, _ = Generator(evo.model, evo.tokenizer, top_k=1,
                                     temperature=0.0).generate(
        input_ids=prompt_ids, num_tokens=n_new)
    full = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(), toks],
                     dim=1)
    ref, _ = evo.model(full)
    ref = ref[:, 511:511 + n_new]
    diff = (step_logits - ref).abs()
    agree = float((step_logits.argmax(-1) == ref.argmax(-1)).float().mean())
    # The decode path (GEMV, dense float32 attention, modal recurrence)
    # rounds its bf16 activations in other places than the full-sequence
    # path (GEMM, flash kernel, chunked conv), and 32 layers of random
    # weights amplify each rounding. The yardstick for that: the same
    # forward with ONE extra bf16 rounding step (a relative 2^-8 of
    # random sign) on the output of layer 0's first norm.
    sign = torch.randint(0, 2, (1, 1, 4096), device=dev, generator=g)
    hook = evo.model.module.blocks[0].pre_norm.register_forward_hook(
        lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
            out.dtype))
    nudged, _ = evo.model(full)
    hook.remove()
    floor = (nudged[:, 511:511 + n_new] - ref).abs()
    steps = [0, 1, 2, 8, 32, n_new - 1]
    log(f'   seam: prefill+decode vs forward logits: max abs diff '
        f'{float(diff.max()):.4f}, mean {float(diff.mean()):.5f} (by step '
        f'{[round(float(diff[:, s].mean()), 5) for s in steps]}), argmax '
        f'agreement {agree:.4f}; logit std {float(ref.std()):.3f}; one '
        f'rounding step at layer 0 moves them by max '
        f'{float(floor.max()):.4f}, mean {float(floor.mean()):.5f}')
    # a fault (a wrong position, cache slot or state) moves logits by
    # their own spread and leaves argmax agreement near chance; the seam
    # must stay within that one rounding step's drift
    check(float(diff.mean()) <= float(floor.mean()) and agree >= 0.75,
          'seam logits disagree')

    # -- 6. where the device time goes (checks nothing; last, so the
    # profiler's hooks cannot slow the timed phases) ----------------------
    from torch.profiler import ProfilerActivity, profile

    def profile_window(label, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.time() - t)
        # kernels only: the GPU-side op annotations (aten::mm, ...) span
        # the kernels they launch and would count them twice
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, 'is_user_annotation', False)),
                     key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in ops)
        log(f'   profile of {label}: device busy {busy_us / 1e3:.1f} ms of '
            f'{wall_us / 1e3:.1f} ms wall (idle share '
            f'{1 - busy_us / wall_us:.3f}); top kernels:')
        for e in ops[:10]:
            log(f'     {100 * e.self_device_time_total / max(busy_us, 1):5.1f}'
                f'%  {e.self_device_time_total / 1e3:8.2f} ms  '
                f'x{e.count:<5d} {e.key[:90]}')

    log('== 6. profiles')
    profile_window('one forward B=1 L=8192', lambda: evo.model(ids))
    profile_window('prefill 2 x 512 + 8 decode steps',
                   lambda: prefill_and_decode(8))

    rows = []
    for kk in kernels.values():
        kk['launches'] = launches['score_sequences'][kk['name']]
        kk['launches_by_phase'] = {p: c[kk['name']]
                                   for p, c in launches.items()}
        rows.append(kk)
    log(smi)
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
