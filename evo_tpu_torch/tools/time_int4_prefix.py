"""Time kernels 8 (weight-only int4 matmul) and 7 (the modal prefix), and
what they feed, on one CUDA card, for the checkout at --root:

    python3 evo_tpu_torch/tools/time_int4_prefix.py --root . [--model]

Prints one JSON line: the card; kernel 8 at M = 1, 2, 3, 4, 5, 8, 9, 16, 32,
64, 128 rows on each of evo-1's four weight shapes (at the rows that take
the streaming design, `GEMV_M_MAX` and fewer, also the wgmma design on
them, `streaming_graph_ms` and `multi_row_graph_ms`: a checkout's own
crossover; at 3-4 rows the parent of the wgmma design took the streaming
one, so timing the two checkouts in turns gives the crossover there), as
device ms per call replayed from a CUDA graph over enough weights to
exceed the 50 MB L2 (a decode step finds each weight cold), as CUDA
events around one call and as host microseconds a call to enqueue
(`route_host_us`), beside its bound and beside
`torch._weight_int4pack_mm` (tinygemm: the same int4 values and
group-128 scales in bf16, another function's rounding; a yardstick the
port never calls) with its scaled error against the plain version; kernel
7 at (1, 4096, 128, 8), chunk 64, alone by graph replay and with its
wrapper between events, with and without a carried state. A checkout
whose `int4_matmul` takes no `out_dtype` gets x padded to Kp, and one
whose `modal_prefix` takes no `s0` is timed without it.

With --model also, random weights from seed 0 on evo-1-131k-base, the
host clock around work that ends in a synchronize: one forward at B=1,
L=8192 unfused, under `hyena_pallas_prefix` and under
`hyena_fused_mixer`; one resumed segment of 8,192 at offset 122,880
under `hyena_pallas_prefix`; decode steps at B=2 after a 512-token
prompt with bf16 weights and with int4 weights and the int8 KV cache,
and at B=8 (the serve CLI's slot count) with int4 weights and the int8
KV cache, each also profiled (device ms and kernels a step, from
`torch.profiler`, and kernel 8's device ms a step). `--decode` runs only
those decode steps of --model. `--quick --rows 8`: kernel 8 alone at
4096 x 12288 and 8 rows, a process short enough to repeat in turns.
`--dots8`: kernel 8c ('dots8') alone at 4096 x 12288 and 1-128 rows (both
of its designs at the rows where the checkout can take either); with
`--variants DIR` also in copies with pieces of its design taken out
(`DOTS8_VARIANTS`), between two runs of the checkout itself.

To compare two versions, run this once per checkout in turns (A, B, B, A)
in one call on one card: the script imports `evo_tpu_torch` from --root,
so an older checkout unpacked beside this one times its own code.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

# evo-1's weight shapes as (K, Kp, N): w1 / w2, w3, w_in / wqkv, w_out
LAYER_SHAPES = ((4096, 4096, 10928), (10928, 11008, 4096),
                (4096, 4096, 12288), (4096, 4096, 4096))
BYTES_S = 3.35e12      # H100 SXM memory, NVIDIA data sheet
BF16_S = 989e12


def time_ms(torch, fn, reps=20, warmup=3):
    """Median ms of fn() between CUDA events, host launch time included."""
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
    """Device ms per call of the calls in `fns`, replayed from a CUDA
    graph (median of 5 replays)."""
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


def host_us(torch, fn, n=200):
    """Host microseconds a call of fn() takes to enqueue (wrapper and
    launch), over n calls back to back with no synchronize among them."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / n


def wall_s(torch, fn, runs):
    """Host seconds of each of `runs` calls of fn() after one warm-up."""
    out = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        if i:
            out.append(time.time() - t)
    return out


def scaled_err(got, want):
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got - want).abs() / want.abs().maximum(rms)).max())


def tinygemm_operands(torch, unpack_int4, packed, scales):
    """The same int4 values and scales in tinygemm's layout: uint8 (N,
    Kp/2) of q = v + 8, even k in the high nibble; bf16 (Kp/128, N, 2)
    scales and zeros, dequantized as (q - 8) * scale + zero."""
    q = (unpack_int4(packed).to(torch.int32) + 8).t().contiguous()
    q8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8)
    w = torch._convert_weight_to_int4pack(q8, 8)
    sz = torch.stack([scales.bfloat16(), torch.zeros_like(scales).bfloat16()],
                     -1).contiguous()
    return w, sz


ROWS = (1, 2, 3, 4, 5, 8, 9, 16, 32, 64, 128)


def int4_section(torch, out, shapes=LAYER_SHAPES, rows=ROWS,
                 yardstick=True):
    from evo_tpu_torch.ops import int4 as int4_mod
    from evo_tpu_torch.ops.int4 import (int4_matmul, int4_matmul_plain,
                                        unpack_int4)
    takes_k = 'out_dtype' in inspect.signature(int4_matmul).parameters
    out['int4_takes_unpadded_x'] = takes_k
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for K, Kp, N in shapes:
        n_w = int(110e6 // (Kp // 2 * N)) + 1
        ws = [(torch.randint(-128, 128, (Kp // 2, N), device=dev,
                             generator=g, dtype=torch.int8),
               torch.rand(Kp // 128, N, device=dev, generator=g) * 0.09
               + 0.01) for _ in range(n_w)]
        tg, tg_error = None, None
        try:
            if yardstick:
                tg = [tinygemm_operands(torch, unpack_int4, p, s)
                      for p, s in ws]
        except Exception as e:          # the yardstick only; report why
            tg_error = f'{type(e).__name__}: {e}'[:300]
        for M in rows:
            x = torch.randn(M, Kp, device=dev, generator=g).bfloat16()
            if Kp > K:
                x[:, K:] = 0
            xk = x[:, :K].contiguous()

            def kernel(p, s):
                """The kernel alone, float32 out (an older checkout's
                takes x padded to Kp)."""
                return int4_matmul(xk if takes_k else x, p, s)

            def route(p, s):
                """What `int4_dot` runs from a bf16 x of K columns to a
                bf16 y (an older checkout pads x and casts y)."""
                if takes_k:
                    return int4_matmul(xk, p, s, torch.bfloat16)
                xp = xk if Kp == K else torch.cat(
                    [xk, xk.new_zeros((M, Kp - K))], dim=1)
                return int4_matmul(xp, p, s).to(torch.bfloat16)
            nbytes = Kp // 2 * N + Kp // 128 * N * 4 + M * K * 2 + M * N * 4
            row = dict(
                graph_ms=time_graph_ms(
                    torch, [lambda p=p, s=s: kernel(p, s) for p, s in ws]),
                events_ms=time_ms(torch, lambda: kernel(*ws[0])),
                route_graph_ms=time_graph_ms(
                    torch, [lambda p=p, s=s: route(p, s) for p, s in ws]),
                route_events_ms=time_ms(torch, lambda: route(*ws[0])),
                route_host_us=host_us(torch, lambda: route(*ws[0])),
                bound_ms=1e3 * max(nbytes / BYTES_S, 2 * M * K * N / BF16_S))
            keep = getattr(int4_mod, 'GEMV_M_MAX', 0)
            if M <= keep:
                # the crossover: both designs at the rows the streaming
                # one takes
                for name, limit in (('streaming', keep), ('multi_row', 0)):
                    int4_mod.GEMV_M_MAX = limit
                    row[f'{name}_graph_ms'] = time_graph_ms(
                        torch, [lambda p=p, s=s: route(p, s) for p, s in ws])
                int4_mod.GEMV_M_MAX = keep
            if tg is not None:
                row['tinygemm_graph_ms'] = time_graph_ms(
                    torch, [lambda w=w, sz=sz: torch._weight_int4pack_mm(
                        x, w, 128, sz) for w, sz in tg])
                row['tinygemm_scaled_err'] = scaled_err(
                    torch._weight_int4pack_mm(x, tg[0][0], 128, tg[0][1]),
                    int4_matmul_plain(x, *ws[0]))
            res[f'{K}x{N}/M={M}'] = row
        if tg_error:
            res[f'{K}x{N}/tinygemm_error'] = tg_error
        del ws, tg
        torch.cuda.empty_cache()
    out['kernel8'] = res


DOTS8_ROWS = (1, 2, 4, 8, 9, 16, 32, 64, 128)


def kernel_ms(torch, calls):
    """Device ms a call of each kernel the calls launch, by name (the
    profiler over one round of the calls, eager)."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return {e.key.split('(')[0][-40:]: e.self_device_time_total / 1e3
            / len(calls)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def dots8_section(torch, out, rows=DOTS8_ROWS):
    """Kernel 8c ('dots8') at 4096 x 12288, bf16 out, each row count by
    graph replay over enough weights to exceed the 50 MB L2; at the rows
    the streaming design may take (`DOTS8_STREAM_MAX` and fewer, where the
    checkout has it) both designs, `streaming_graph_ms` and
    `tensor_cores_graph_ms`: the crossover."""
    from evo_tpu_torch.ops import int4 as int4_mod
    K, Kp, N = 4096, 4096, 12288
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(2)
    ws = [(torch.randint(-128, 128, (Kp // 2, N), device=dev, generator=g,
                         dtype=torch.int8),
           torch.rand(Kp // 128, N, device=dev, generator=g) * 0.09 + 0.01)
          for _ in range(int(110e6 // (Kp // 2 * N)) + 1)]
    keep = getattr(int4_mod, 'DOTS8_STREAM_MAX', None)
    res = {}
    for M in rows:
        x = torch.randn(M, K, device=dev, generator=g).bfloat16()
        calls = [lambda p=p, s=s: int4_mod.int4_matmul(
            x, p, s, torch.bfloat16, mode='dots8') for p, s in ws]
        row = dict(graph_ms=time_graph_ms(torch, calls),
                   kernels_ms=kernel_ms(torch, calls))
        if keep is not None and M <= keep:
            for name, limit in (('streaming', keep), ('tensor_cores', 0)):
                int4_mod.DOTS8_STREAM_MAX = limit
                row[f'{name}_graph_ms'] = time_graph_ms(torch, calls)
            int4_mod.DOTS8_STREAM_MAX = keep
        res[f'M={M}'] = row
    out['dots8'] = res
    del ws
    torch.cuda.empty_cache()


def prefix_section(torch, out):
    from evo_tpu_torch.ops import modal_prefix as prefix_mod
    takes_s0 = 's0' in inspect.signature(prefix_mod.modal_prefix).parameters
    out['prefix_takes_s0'] = takes_s0
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(1)
    B, D, K, S = 1, 4096, 128, 8
    cases = [(torch.randn(B, D, K, S, device=dev, generator=g),
              torch.randn(B, D, K, S, device=dev, generator=g))
             for _ in range(5)]
    logmag = torch.log(torch.rand(D, S, device=dev, generator=g) * 0.48
                       + 0.5)
    theta = (torch.rand(D, S, device=dev, generator=g) * 2 - 1) * 3.1
    s0 = torch.randn(B, D, S, 2, device=dev, generator=g)

    def call(c, st=None):
        if st is None:
            return lambda: prefix_mod.modal_prefix(*c, logmag, theta, 64)
        return lambda: prefix_mod.modal_prefix(*c, logmag, theta, 64, st)
    nbytes = (4 * B * D * K * S + 2 * D * S + 2 * B * D * S) * 4
    out['kernel7'] = dict(
        graph_ms=time_graph_ms(torch, [call(c) for c in cases]),
        events_ms=time_ms(torch, call(cases[0])),
        bound_ms=1e3 * nbytes / BYTES_S)
    if takes_s0:
        out['kernel7'].update(
            carried_graph_ms=time_graph_ms(torch,
                                           [call(c, s0) for c in cases]),
            carried_events_ms=time_ms(torch, call(cases[0], s0)))
    del cases
    torch.cuda.empty_cache()


def profiled_steps(torch, model_lib, m, prompt, n_steps=4):
    """(device ms, kernels) a decode step of the prompt's batch, from the
    profiler over `n_steps` steps after a prefill outside the window, kernel
    8's share of it, and the wall ms a step of 16 more steps unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    cache = m.initialize_inference_params(prompt.shape[0],
                                          prompt.shape[1] + n_steps + 20)
    logits, cache = m(prompt, inference_params_dict=cache)
    tok = logits[:, -1].argmax(-1)
    for _ in range(2):
        step, cache = model_lib.decode_step(m.module, tok, cache)
        tok = step.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step, cache = model_lib.decode_step(m.module, tok, cache)
            tok = step.argmax(-1)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, 'is_user_annotation', False)]
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / n_steps
    count = sum(e.count for e in ops) / n_steps
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:3]
    k8 = sum(e.self_device_time_total for e in ops
             if 'int4_' in e.key) / 1e3 / n_steps
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(12):
        step, cache = model_lib.decode_step(m.module, tok, cache)
        tok = step.argmax(-1)
    torch.cuda.synchronize()
    return dict(device_ms=busy, kernels=count, kernel8_ms=k8,
                wall_ms=1e3 * (time.time() - t) / 12,
                top=[(e.key[:60], e.self_device_time_total / 1e3 / n_steps)
                     for e in top])


def model_section(torch, out, decode_only=False):
    from evo_tpu_torch import Evo
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.ops import _build
    L = 8192
    ids = torch.randint(65, 85, (1, L), generator=torch.Generator()
                        .manual_seed(0))
    prompt8 = torch.randint(65, 85, (8, 512), generator=torch.Generator()
                            .manual_seed(1))
    prompt = prompt8[:2]
    evo = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda')
    model, base = evo.model, evo.model.config

    def configure(**flags):
        cfg = base.replace(**flags)
        model.config = model.module.config = cfg

    for key, flags in (() if decode_only else (
            ('forward_8192_s', {}),
            ('prefix_forward_8192_s', {'hyena_pallas_prefix': True}),
            ('fused_forward_8192_s', {'hyena_fused_mixer': True}))):
        configure(**flags)
        out[key] = wall_s(torch, lambda: model(ids), 3)
        if flags.get('hyena_pallas_prefix'):
            _build.LAUNCHES.clear()
            model(ids)
            torch.cuda.synchronize()
            if _build.LAUNCHES['modal_prefix'] != 29:
                raise RuntimeError(f'{_build.LAUNCHES}: the prefix forward '
                                   'did not take kernel 7 29 times')
    if not decode_only:
        configure(hyena_pallas_prefix=True)
        cache = model.initialize_inference_params(1, 131072 + 1024)

        def segment():
            cache['offset'] = 122880
            model(ids, inference_params_dict=cache, resume=True)
        out['prefix_resumed_segment_s'] = wall_s(torch, segment, 2)
        del cache
    configure()
    out['decode_bf16'] = profiled_steps(torch, model_lib, model, prompt)
    del evo, model
    torch.cuda.empty_cache()
    evo4 = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda',
               config_overrides={'weight_quant': 'int4',
                                 'kv_quant': 'int8'})
    _build.LAUNCHES.clear()
    out['decode_int4_int8kv'] = profiled_steps(torch, model_lib, evo4.model,
                                               prompt)
    out['decode_int4_launches'] = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()
    out['decode_int4_int8kv_b8'] = profiled_steps(torch, model_lib,
                                                  evo4.model, prompt8)
    out['decode_int4_b8_launches'] = dict(_build.LAUNCHES)


# Edits of csrc/int4_matmul.cu that take one part of kernel 8's work out
# at M <= 8 (the outputs are then wrong, only the time counts): the
# nibble-to-float conversion (a LOP3 and a subtract a weight; the raw
# words stand in, so the FMAs stay), and all arithmetic on the loaded
# words (one add a word stands in), which leaves the copies into shared
# memory, the barriers and the partial sums; the last block's sum of the
# splits (with its ticket); and the copies of the weight (the copies write
# zeros and read nothing)
_CONVERT = (
    """        const float vl[4] = {nibble_at<0>(w, k0), nibble_at<8>(w, k8),
                             nibble_at<16>(w, k16), nibble_at<8>(w2, k8)};
        const float vh[4] = {nibble_at<4>(w, k4), nibble_at<12>(w, k12),
                             nibble_at<4>(w2, k4), nibble_at<12>(w2, k12)};""",
    """        const float fw = __uint_as_float(w), fw2 = __uint_as_float(w2);
        const float vl[4] = {fw, fw2, -fw, -fw2};
        const float vh[4] = {fw2, fw, -fw2, -fw};""")
_MATH = (
    """            plo[m][j] = fmaf(xl[m][r], wl[j], plo[m][j]);
            phi[m][j] = fmaf(xh[m][r], wh[j], phi[m][j]);""",
    """            if (m == 0 && j == 0) plo[0][0] += __uint_as_float(w);""")
_COMBINE = ('  if (splits == 1) return;\n', '  return;\n')
_LOADS = ('                         valid > 0 ? 16 : 0);',
          '                         0);')
VARIANTS = {'without_conversion': [_CONVERT], 'without_arithmetic': [_MATH],
            'without_combine': [_COMBINE],
            'without_arithmetic_combine': [_MATH, _COMBINE],
            'without_loads': [_LOADS],
            'without_loads_combine': [_LOADS, _COMBINE],
            'without_loads_arithmetic_combine': [_LOADS, _MATH, _COMBINE]}


# Edits of csrc/int4_dots8.cu that take one piece of 'dots8''s design
# out (the outputs stay right): the programmatic dependent launch of its
# product (a plain launch after the quantize launch's end), and the quantize
# launch's 16-byte loads (one value at a time)
DOTS8_VARIANTS = {
    'without_pdl': [('constexpr int kPdl = 1;', 'constexpr int kPdl = 0;')],
    'scalar_quantize': [
        ('const int vec = K % 8 == 0 && (uintptr_t)x % 16 == 0;',
         'const int vec = 0;')]}


def time_variants(root, out_dir, source='int4_matmul.cu', variants=None,
                  flags=('--quick',), key='kernel8'):
    """Kernel 8's graph-replay ms at 4096 x 12288, M = 1 and 2, in each
    variant of `VARIANTS` (or the edits `variants` of `source`, timed by
    the tool's `flags`, the `key` of its line), each run in a process of
    its own on a copy of the checkout's package."""
    import shutil
    times = {}
    for name, edits in (VARIANTS if variants is None else variants).items():
        dst = os.path.join(os.path.abspath(out_dir), name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, 'evo_tpu_torch'),
                        os.path.join(dst, 'evo_tpu_torch'),
                        ignore=shutil.ignore_patterns('build', '__pycache__'))
        src = os.path.join(dst, 'evo_tpu_torch', 'csrc', source)
        with open(src) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'time_int4_prefix --variants: {name}: '
                                   f'the kernel source no longer has {old!r}')
            text = text.replace(old, new)
        with open(src, 'w') as f:
            f.write(text)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--root', dst, *flags], capture_output=True,
                             text=True, timeout=900, check=True)
        k8 = json.loads(res.stdout.strip().splitlines()[-1])[key]
        times[name] = {k: v['graph_ms'] for k, v in k8.items()}
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--model', action='store_true')
    ap.add_argument('--decode', action='store_true',
                    help="only --model's decode steps")
    ap.add_argument('--quick', action='store_true',
                    help='kernel 8 alone, at 4096 x 12288 and the rows of '
                         '--rows')
    ap.add_argument('--rows', default='1,2',
                    help="--quick's row counts, comma-separated")
    ap.add_argument('--dots8', action='store_true',
                    help="kernel 8c ('dots8') alone, at 4096 x 12288 and "
                         'the rows of DOTS8_ROWS')
    ap.add_argument('--variants', default='',
                    help='also time the edits of VARIANTS in copies of the '
                         'package written under this directory')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('time_int4_prefix: no CUDA device\n')
        return 1
    out = dict(root=root, card=subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip())
    if args.dots8:
        dots8_section(torch, out)
        if args.variants:
            # in turns: this checkout before and after the variants
            first = out['dots8']
            out['dots8_variants_graph_ms'] = time_variants(
                root, args.variants, 'int4_dots8.cu', DOTS8_VARIANTS,
                ('--dots8',), 'dots8')
            dots8_section(torch, out)
            out['dots8'], out['dots8_again'] = first, out['dots8']
        print(json.dumps(out), flush=True)
        return 0
    if args.quick:
        int4_section(torch, out, shapes=LAYER_SHAPES[2:3],
                     rows=tuple(int(m) for m in args.rows.split(',')),
                     yardstick=False)
        print(json.dumps(out), flush=True)
        return 0
    int4_section(torch, out)
    prefix_section(torch, out)
    if args.model or args.decode:
        model_section(torch, out, decode_only=args.decode)
    if args.variants:
        out['kernel8_variants_graph_ms'] = time_variants(root, args.variants)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
