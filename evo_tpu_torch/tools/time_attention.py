"""Time the port's attention kernels (3, 4 and 5), the MLP-gate kernel (9)
and what they feed, on one CUDA card, for the checkout at --root:

    python3 evo_tpu_torch/tools/time_attention.py --root . [--model]

Prints one JSON line: the card, kernel 3 at q/k/v (1, 8192, 32, 128)
(views of one QKV tensor), kernels 4 and 5 at a segment of 8,192 queries
at offset 122,880 of a 131,072-long bf16 or int8 buffer and at one query
row, SDPA at the same inputs (causal, and lower-right causal over the live
prefix of the buffer), and kernel 9 at x (8192, 4096) and (2, 4096) with
w1, w2 (4096, 10928) beside `F.gelu(x @ w1) * (x @ w2)`; all medians of
CUDA events. With --model also, random weights from seed 0 and the host
clock around work that ends in a synchronize: one forward of
evo-1-8k-base at B=1, L=8192, one resumed segment of evo-1-131k-base at
offset 122,880, and the ms a decode step at B=2 after a 512-token prompt
with evo-1-8k-base (bf16 cache) and evo-1-131k-base under the int8 KV
cache: the decode steps are host-bound, so they show what else moved.

With --split instead, only the buffer kernels at few query rows, each
beside SDPA over the live prefix and its bytes bound, by CUDA graph
replay: kernel 4 at one row at offsets 8,191, 65,535 and 122,879 of a
131,072-long bf16 buffer and at 4 and 9 rows at offset 8,000; kernel 5
at one row at the same three offsets of an int8 buffer, with an int
offset and with a (1,) device offset; and, where the checkout has the
bf16 split (`SPLIT_MAX_ROWS_BF16`), kernel 4 at 1, 2, 4, 8, 9 and 16 rows
at the end of the buffer and at offset 8,000 in both regimes.

To compare two versions, run this once per checkout in turns (A, B, B, A)
in one session on one card: the script imports `evo_tpu_torch` from
--root, so an older checkout unpacked beside this one times its own
kernels.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def time_ms(torch, fn, reps, warmup=1):
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


def time_graph_ms(torch, fn, rounds=10):
    """Device ms a call of fn, replayed from a CUDA graph of `rounds`
    calls (for calls shorter than the host takes to launch them)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
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
        times.append(a.elapsed_time(b) / rounds)
    return statistics.median(times)


def split_times(torch, dev, randn, out):
    """The --split mode (see the top of the file)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from evo_tpu_torch.layers.attention import kv_quantize
    from evo_tpu_torch.ops import attention_buffer as ab
    fab = ab.flash_attention_buffer
    H, Dh, T = 32, 128, 131072
    rate = 3.35e12                      # H100 SXM HBM3 bytes/s

    def sdpa(q, kb, vb, o):
        live = o + q.shape[1]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kb[:, :live],
                                                 vb[:, :live]))
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=causal_lower_right(q.shape[1], live))

    def graph_or_events(fn):
        try:
            return time_graph_ms(torch, fn)
        except RuntimeError:
            torch.cuda.synchronize()
            return time_ms(torch, fn, reps=10)

    kb, vb = randn(1, T, H, Dh), randn(1, T, H, Dh)
    k4 = {}
    for rows, o in ((1, 8191), (1, 65535), (1, 122879), (4, 8000),
                    (9, 8000)):
        q = randn(1, rows, H, Dh)
        k4[f'rows={rows} offset={o}'] = dict(
            ms=time_graph_ms(torch, lambda: fab(q, kb, vb, o)),
            library_ms=graph_or_events(lambda: sdpa(q, kb, vb, o)),
            bound_ms=1e3 * (2 * (o + rows) + 2 * rows) * H * Dh * 2 / rate)
    out['kernel4'] = k4
    if hasattr(ab, 'SPLIT_MAX_ROWS_BF16'):
        regimes, keep = {}, ab.SPLIT_MAX_ROWS_BF16
        for o_end in (True, False):
            for rows in (1, 2, 4, 8, 9, 16):
                o = T - rows if o_end else 8000
                q = randn(1, rows, H, Dh)
                e = dict(bound_ms=1e3 * (2 * (o + rows) + 2 * rows) * H * Dh
                         * 2 / rate)
                if rows <= keep:
                    e['split_ms'] = time_graph_ms(
                        torch, lambda: fab(q, kb, vb, o))
                ab.SPLIT_MAX_ROWS_BF16 = 0
                try:
                    e['mainloop_ms'] = time_graph_ms(
                        torch, lambda: fab(q, kb, vb, o))
                finally:
                    ab.SPLIT_MAX_ROWS_BF16 = keep
                regimes[f'rows={rows} offset={o}'] = e
        out['kernel4_regimes'] = regimes
    (kq, ks), (vq, vs) = kv_quantize(kb), kv_quantize(vb)
    del kb, vb
    i8 = [t.transpose(1, 2).contiguous() for t in (kq, vq, ks, vs)]
    del kq, ks, vq, vs
    q1 = randn(1, 1, H, Dh)
    k5 = {}
    for o in (8191, 65535, 122879):
        dev_off = torch.full((1,), o, dtype=torch.int32, device=dev)
        k5[f'offset={o}'] = dict(
            int_offset_ms=time_graph_ms(
                torch, lambda: fab(q1, i8[0], i8[1], o, i8[2], i8[3])),
            device_offset_ms=time_graph_ms(
                torch, lambda: fab(q1, i8[0], i8[1], dev_off, i8[2],
                                   i8[3])),
            bound_ms=1e3 * 2 * H * (o + 1) * (Dh + 4) / rate)
    out['kernel5'] = k5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--model', action='store_true')
    ap.add_argument('--split', action='store_true',
                    help='only the buffer kernels at few query rows')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    if not torch.cuda.is_available():
        sys.stderr.write('time_attention: no CUDA device\n')
        return 1
    from evo_tpu_torch.ops.attention import flash_attention_causal
    from evo_tpu_torch.ops.attention_buffer import flash_attention_buffer

    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    out = dict(root=root, card=subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip())
    if args.split:
        split_times(torch, dev, randn, out)
        print(json.dumps(out), flush=True)
        return 0
    H, Dh, L = 32, 128, 8192
    qkv = randn(1, L, 3, H, Dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out['kernel3_ms'] = time_ms(
        torch, lambda: flash_attention_causal(q, k, v), reps=20, warmup=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out['sdpa_causal_ms'] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=20, warmup=3)
    del qkv, q, k, v, qt, kt, vt

    T, offset = 131072, 122880
    live = offset + L
    q, kb, vb = randn(1, L, H, Dh), randn(1, T, H, Dh), randn(1, T, H, Dh)
    out['kernel4_ms'] = time_ms(
        torch, lambda: flash_attention_buffer(q, kb, vb, offset), reps=5)
    q1 = randn(1, 1, H, Dh)
    out['kernel4_decode_ms'] = time_ms(
        torch, lambda: flash_attention_buffer(q1, kb, vb, offset - 1), reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kb[:, :live], vb[:, :live]))
    bias = causal_lower_right(L, live)
    out['sdpa_lower_right_ms'] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias), reps=5)
    out['sdpa_decode_ms'] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q1.transpose(1, 2), kt[:, :, :offset], vt[:, :, :offset]),
        reps=10)
    from evo_tpu_torch.layers.attention import kv_quantize
    (kq, ks), (vq, vs) = kv_quantize(kb), kv_quantize(vb)
    i8 = [t.transpose(1, 2).contiguous() for t in (kq, vq, ks, vs)]
    del kq, ks, vq, vs
    out['kernel5_ms'] = time_ms(
        torch, lambda: flash_attention_buffer(q, i8[0], i8[1], offset,
                                              i8[2], i8[3]), reps=5)
    out['kernel5_decode_ms'] = time_ms(
        torch, lambda: flash_attention_buffer(q1, i8[0], i8[1], offset - 1,
                                              i8[2], i8[3]), reps=10)
    del q, kb, vb, qt, kt, vt, q1, i8

    from evo_tpu_torch.ops.mlp_gate import fused_gate
    w1, w2 = randn(4096, 10928), randn(4096, 10928)
    for M in (8192, 2):
        x = randn(M, 4096)
        out[f'kernel9_m{M}_ms'] = time_ms(
            torch, lambda: fused_gate(x, w1, w2), reps=10, warmup=2)
        out[f'library9_m{M}_ms'] = time_ms(
            torch, lambda: F.gelu(x @ w1) * (x @ w2), reps=10, warmup=2)
    del w1, w2, x

    if args.model:
        from evo_tpu_torch import Evo
        from evo_tpu_torch import model as model_lib
        ids = torch.randint(65, 85, (1, L), generator=torch.Generator()
                            .manual_seed(0))
        prompt = torch.randint(65, 85, (2, 512), generator=torch.Generator()
                               .manual_seed(1))

        def decode_ms(m, n_steps=16):
            cache = m.initialize_inference_params(2, 512 + n_steps + 1)
            logits, cache = m(prompt, inference_params_dict=cache)
            tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            t = time.time()
            for _ in range(n_steps):
                step, cache = model_lib.decode_step(m.module, tok, cache)
                tok = step.argmax(-1)
            torch.cuda.synchronize()
            return 1e3 * (time.time() - t) / n_steps

        evo = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda')
        forwards = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.time()
            evo.model(ids)
            torch.cuda.synchronize()
            forwards.append(time.time() - t)
        out['forward_8192_s'] = forwards[1:]
        out['decode_step_ms'] = [decode_ms(evo.model) for _ in range(3)][1:]
        del evo
        torch.cuda.empty_cache()
        model = Evo('evo-1-131k-base', random_init=True, seed=0,
                    device='cuda').model
        cache = model.initialize_inference_params(1, T + 1024)
        segments = []
        for _ in range(3):
            cache['offset'] = offset
            torch.cuda.synchronize()
            t = time.time()
            model(ids, inference_params_dict=cache, resume=True)
            torch.cuda.synchronize()
            segments.append(time.time() - t)
        out['resumed_segment_s'] = segments[1:]
        del model, cache
        torch.cuda.empty_cache()
        model = Evo('evo-1-131k-base', random_init=True, seed=0,
                    device='cuda', config_overrides={'kv_quant': 'int8'}
                    ).model
        out['decode_step_int8_kv_ms'] = [decode_ms(model)
                                         for _ in range(3)][1:]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
