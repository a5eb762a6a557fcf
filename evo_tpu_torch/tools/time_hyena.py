"""Time kernels 2 (FIR + gate) and 6 (the fused mixer) and the Hyena
layer's routes into them, and what they feed, on one CUDA card, for the
checkout at --root:

    python3 evo_tpu_torch/tools/time_hyena.py --root . [--model] \
        [--phases OUT_DIR]

Prints one JSON line: the card; at zl (1, 8192, 3, 4096) bf16 with the
in-projection bias, each kernel alone and the layer's whole route from the
in-projection's output to the kernel's result ((x2, u) for kernel 2, y for
kernel 6, chunk 64, 8 modal states), each as device ms per call replayed
from a CUDA graph over six buffers (larger together than the L2, as a
forward finds them) and as CUDA events around one call. A checkout whose
`fir_gate` / `hyena_mixer` takes `b_in` reads zl in place; an older one
takes the biased contiguous (B, 3, C, L) copy, whose bias pass and copy
its route then includes. `--phases` also times kernel 6 in copies of the
checkout's `evo_tpu_torch` written under OUT_DIR, each with one part of
its work taken out (`PHASES`; the outputs are then wrong, only the time
counts), to show where its time goes. With --model also, random weights from seed 0 and the host clock around work
that ends in a synchronize: forwards of evo-1-8k-base at B=1, L=8192,
unfused and under `hyena_fused_mixer` (each with the peak allocation
above the weights); decode steps at B=2 after a 512-token prompt; one
resumed segment of evo-1-131k-base at offset 122,880; and 131,072 nt
scored in segments of 8,192, unfused and fused.

To compare two versions, run this once per checkout in turns (A, B, B, A)
in one call on one card: the script imports `evo_tpu_torch` from
--root, so an older checkout unpacked beside this one times its own code.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--model', action='store_true')
    ap.add_argument('--phases', default='')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('time_hyena: no CUDA device\n')
        return 1
    from evo_tpu_torch.ops import hyena_mixer as mixer_mod
    from evo_tpu_torch.ops.fir_gate import fir_gate

    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    in_place = 'b_in' in inspect.signature(fir_gate).parameters
    out = dict(root=root, in_place=in_place, card=subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip())
    D, L = 4096, 8192
    fw, fb, b_in = randn(3, D, 3), randn(3, D), randn(3, D)
    zls = [randn(1, L, 3, D) for _ in range(6)]

    def route(zl):
        """From the in-projection's output to (x2, u), as the layer goes."""
        if in_place:
            return lambda: fir_gate(zl.permute(0, 2, 3, 1), fw, fb,
                                    b_in=b_in)
        return lambda: fir_gate((zl + b_in).permute(0, 2, 3, 1).contiguous(),
                                fw, fb)

    zs = []      # an older checkout's kernel input: the biased copies
    if in_place:
        kernels = [route(zl) for zl in zls]
    else:
        zs = [(zl + b_in).permute(0, 2, 3, 1).contiguous() for zl in zls]
        kernels = [lambda z=z: fir_gate(z, fw, fb) for z in zs]
    out['kernel2_graph_ms'] = time_graph_ms(torch, kernels)
    out['kernel2_events_ms'] = time_ms(torch, kernels[0])
    out['route_graph_ms'] = time_graph_ms(torch, [route(z) for z in zls])
    out['route_events_ms'] = time_ms(torch, route(zls[0]))

    # kernel 6 and the fused layer's route from zl to y
    hyena_mixer = mixer_mod.hyena_mixer
    mixer_in_place = 'b_in' in inspect.signature(hyena_mixer).parameters
    out['mixer_in_place'] = mixer_in_place
    S = 8
    mag = torch.rand(D, S, device=dev, generator=g) * 0.48 + 0.5
    ang = (torch.rand(D, S, device=dev, generator=g) * 2 - 1) * 3.1
    poles = torch.stack([mag * torch.cos(ang), mag * torch.sin(ang)], -1)
    residues = torch.randn(D, S, 2, device=dev, generator=g) * 0.3
    mixer_args = (fw * 0.5, fb * 0.1, poles, residues, randn(D))
    state = (randn(1, 3, D, 2), randn(1, D, S, 2).float())

    def mixer_route(zl, st=None):
        """From the in-projection's output to y, as the fused layer goes."""
        if mixer_in_place:
            return lambda: hyena_mixer(zl.permute(0, 2, 3, 1), *mixer_args,
                                       chunk=64, state=st, b_in=b_in)
        return lambda: hyena_mixer(
            (zl + b_in).permute(0, 2, 3, 1).contiguous(), *mixer_args,
            chunk=64, state=st)

    if mixer_in_place:
        mixers = [mixer_route(zl) for zl in zls]
        carried = [mixer_route(zl, state) for zl in zls]
    else:
        if not zs:
            zs = [(zl + b_in).permute(0, 2, 3, 1).contiguous() for zl in zls]
        mixers = [lambda z=z: hyena_mixer(z, *mixer_args, chunk=64)
                  for z in zs]
        carried = [lambda z=z: hyena_mixer(z, *mixer_args, chunk=64,
                                           state=state) for z in zs]
    out['kernel6_graph_ms'] = time_graph_ms(torch, mixers)
    out['kernel6_carried_graph_ms'] = time_graph_ms(torch, carried)
    out['kernel6_events_ms'] = time_ms(torch, mixers[0])
    out['mixer_route_graph_ms'] = time_graph_ms(
        torch, [mixer_route(zl) for zl in zls])
    out['mixer_route_events_ms'] = time_ms(torch, mixer_route(zls[0]))
    del zls, kernels, zs, mixers, carried
    torch.cuda.empty_cache()

    if args.model:
        import numpy as np
        from evo_tpu_torch import Evo, score_sequences_segmented
        from evo_tpu_torch import model as model_lib
        from evo_tpu_torch.tokenizer import CharLevelTokenizer
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

        for key, overrides in (('forward_8192_s', {}),
                               ('fused_forward_8192_s',
                                {'hyena_fused_mixer': True})):
            model = Evo('evo-1-8k-base', random_init=True, seed=0,
                        device='cuda', config_overrides=overrides).model
            out[key] = wall_s(torch, lambda: model(ids), 3)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            model(ids)
            torch.cuda.synchronize()
            out[key[:-2] + '_peak_gib_above_weights'] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 30
            if not overrides:
                out['decode_step_ms'] = [decode_ms(model)
                                         for _ in range(3)][1:]
            del model
            torch.cuda.empty_cache()
        model = Evo('evo-1-131k-base', random_init=True, seed=0,
                    device='cuda').model
        cache = model.initialize_inference_params(1, 131072 + 1024)

        def segment():
            cache['offset'] = 122880
            model(ids, inference_params_dict=cache, resume=True)
        out['resumed_segment_s'] = wall_s(torch, segment, 2)
        del cache
        torch.cuda.empty_cache()
        rng = np.random.default_rng(0)
        seq = ''.join(rng.choice(list('ACGT'), 131072))
        tok = CharLevelTokenizer(512)
        out['score_131072_s'] = wall_s(
            torch, lambda: score_sequences_segmented([seq], model, tok,
                                                     segment_len=8192), 2)
        del model
        torch.cuda.empty_cache()
        model = Evo('evo-1-131k-base', random_init=True, seed=0,
                    device='cuda',
                    config_overrides={'hyena_fused_mixer': True}).model
        out['fused_score_131072_s'] = wall_s(
            torch, lambda: score_sequences_segmented([seq], model, tok,
                                                     segment_len=8192), 2)
    if args.phases:
        out['kernel6_phases_graph_ms'] = time_phases(root, args.phases)
    print(json.dumps(out), flush=True)
    return 0


# Edits of csrc/hyena_mixer.cu that take one part of kernel 6's work out:
# the loads of zl, the FIR arithmetic, the Toeplitz product, and the state
# work (y_state and the injection)
_NO_LOADS = ('    if (q < K) {\n      const int slot',
             '    if (q < 0) {\n      const int slot')
_NO_FIR = ('          const float z0 = evo::to_float(biased(t0 + k));\n'
           '          // taps and inputs are bf16, so each product is exact '
           'in float32\n'
           "          // and a fused multiply-add rounds as the plain "
           "version's\n"
           '          // product-then-add\n'
           '          float acc = w[s][0] * z2;\n'
           '          acc = fmaf(w[s][1], z1, acc);\n'
           '          acc = fmaf(w[s][2], z0, acc);\n'
           '          if (has_fb) acc = __fadd_rn(acc, fbv[s]);\n'
           '          const float f = bf16_round(acc);',
           '          const float z0 = evo::to_float(sm.z[slot][t0 + k][s]'
           '[ch]);\n          const float f = z0;')
_NO_TOEPLITZ = ('        if (cb > t0) break;', '        if (cb >= 0) break;')
_NO_STATE = [('        if (s < S) {', '        if (s < 0) {'),
             ('      if (owner) {', '      if (S < 0) {')]
PHASES = {
    'without_loads': [_NO_LOADS],
    'without_loads_fir': [_NO_LOADS, _NO_FIR],
    'without_loads_toeplitz': [_NO_LOADS, _NO_TOEPLITZ],
    'without_loads_state': [_NO_LOADS, *_NO_STATE],
    'without_loads_fir_toeplitz_state': [_NO_LOADS, _NO_FIR, _NO_TOEPLITZ,
                                         *_NO_STATE],
}


def time_phases(root, out_dir):
    """Kernel 6's graph-replay ms in each variant of `PHASES`, each run in
    a process of its own on a copy of the checkout's package."""
    import shutil
    times = {}
    for name, edits in PHASES.items():
        dst = os.path.join(os.path.abspath(out_dir), name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, 'evo_tpu_torch'),
                        os.path.join(dst, 'evo_tpu_torch'),
                        ignore=shutil.ignore_patterns('build', '__pycache__'))
        src = os.path.join(dst, 'evo_tpu_torch', 'csrc', 'hyena_mixer.cu')
        with open(src) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'time_hyena --phases: {name}: the '
                                   f'kernel source no longer has {old!r}')
            text = text.replace(old, new)
        with open(src, 'w') as f:
            f.write(text)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--root', dst], capture_output=True,
                             text=True, timeout=900, check=True)
        times[name] = json.loads(res.stdout.strip().splitlines()[-1])[
            'kernel6_graph_ms']
    return times


if __name__ == '__main__':
    sys.exit(main())
