"""The one-rounding yardstick of `chip_smoke.py`'s teacher-forcing checks
over several random draws, beside the distances those checks hold
against it, on one CUDA card, for the checkout at --root:

    python3 evo_tpu_torch/tools/yardstick_draws.py --root . [--draws 8]

The yardstick is one forward with a relative 2^-8 nudge of random sign on
the output of layer 0's first norm (`chip_smoke.py`, phase 5's
`nudged_forward`); its size moves with the 4,096 signs drawn. This script
draws them --draws times from generators of their own (seeds
--first-seed, --first-seed + 1, ...) and takes, at the inputs of the
checks, each draw's yardstick next to the one distance the check
measures (which no draw moves):
- phase 5: the decode seam of evo-1-8k-base (2 x 512 nt + 64 greedy
  tokens; mean |step logits - forward logits|);
- phase 18: the teacher-forced log-probs of speculative decoding on
  evo-1-8k-base in bf16 at g = 8 (the repetitive and the random prompt
  with the n-gram drafter, and the oracle drafter's schedule), and on
  evo-1-131k-base under int4 weights and the int8 KV cache at g = 3 and
  8 (the repetitive prompt).
Prints one JSON line: per check the distance, the yardstick of every
draw, their median, min and max, and whether the distance lies below the
median. Random weights from seed 0 and the prompts of `chip_smoke.py`.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--draws', type=int, default=8)
    ap.add_argument('--first-seed', type=int, default=1000)
    ap.add_argument('--out', default=None,
                    help='also write the JSON line to this file')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('yardstick_draws: no CUDA device\n')
        return 1
    from evo_tpu_torch import Evo, generate_speculative
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.scoring import prepare_batch
    from evo_tpu_torch.tools.spec_agreement import OracleDrafter

    t_start = time.time()
    dev = torch.device('cuda')
    signs = [torch.randint(0, 2, (1, 1, 4096), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               args.first_seed + i))
             for i in range(args.draws)]

    def nudged(model, tokens, sign):
        hook = model.module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype))
        try:
            logits, _ = model(tokens)
        finally:
            hook.remove()
        return logits

    checks = {}

    def record(name, distance, yardsticks):
        med = statistics.median(yardsticks)
        checks[name] = dict(distance=distance, yardsticks=yardsticks,
                            median=med, min=min(yardsticks),
                            max=max(yardsticks),
                            below_median=distance < med,
                            passes_draws=sum(distance <= f
                                             for f in yardsticks))

    with torch.no_grad():
        evo = Evo('evo-1-8k-base', random_init=True, seed=0, device='cuda')
        tok = evo.tokenizer
        # phase 4's and 5's draws, in their order
        rng = np.random.default_rng(0)
        [''.join(rng.choice(list('ACGT'), n)) for n in (1000, 2300, 3100,
                                                         4000)]
        rng.integers(65, 85, (1, 8192))
        prompts = [''.join(rng.choice(list('ACGT'), 512)) for _ in range(2)]
        prompt_ids = prepare_batch(prompts, tok, prepend_bos=False)[0]
        n_new = 64
        toks, step_logits, _ = Generator(evo.model, tok, top_k=1,
                                         temperature=0.0).generate(
            input_ids=prompt_ids, num_tokens=n_new)
        full = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(),
                          toks], dim=1)
        ref = evo.model(full)[0][:, 511:511 + n_new]
        record('phase5_seam', float((step_logits - ref).abs().mean()), [
            float((nudged(evo.model, full, s)[:, 511:511 + n_new] - ref)
                  .abs().mean()) for s in signs])

        rng18 = np.random.default_rng(18)
        unit18 = ''.join(rng18.choice(list('ACGT'), 64))
        prompts18 = {'repetitive': unit18 * 8,
                     'non-repetitive': ''.join(rng18.choice(list('ACGT'),
                                                            512))}

        def teacher_forced(name, model, prompt, toks, logps):
            P = len(prompt)
            full = torch.as_tensor(np.concatenate(
                [tok.tokenize(prompt), toks]), device=dev).long()[None]
            nxt = full[0, P:]
            ref = torch.log_softmax(model(full)[0][0, P - 1:-1].float(), -1)
            lp_ref = ref.gather(-1, nxt[:, None])[:, 0]
            d = float((torch.as_tensor(logps, device=dev) - lp_ref).abs()
                      .mean())
            fs = []
            for s in signs:
                nud = torch.log_softmax(nudged(model, full, s)[
                    0, P - 1:-1].float(), -1)
                fs.append(float((nud.gather(-1, nxt[:, None])[:, 0]
                                 - lp_ref).abs().mean()))
            record(name, d, fs)

        # phase 18's warm-up, then its runs in its order
        generate_speculative(evo.model, tok, prompt=prompts18[
            'non-repetitive'][:200], num_tokens=12, gamma=8)
        for label in ('repetitive', 'non-repetitive'):
            toks, logps, _ = generate_speculative(
                evo.model, tok, prompt=prompts18[label], num_tokens=32,
                gamma=8)
            teacher_forced(f'phase18_bf16_g8_{label}', evo.model,
                           prompts18[label], toks, logps)
        prompt = prompts18['non-repetitive']
        oracle = OracleDrafter(evo.model, tok, len(prompt),
                               [8, 8, 5, 8, 2, 0, 8, 3])
        with oracle.installed():
            toks, logps, _ = generate_speculative(
                evo.model, tok, prompt=prompt, num_tokens=64, gamma=8)
        teacher_forced('phase18_bf16_g8_oracle', evo.model, prompt, toks,
                       logps)
        del evo, oracle
        torch.cuda.empty_cache()

        evo4 = Evo('evo-1-131k-base', random_init=True, seed=0,
                   device='cuda', config_overrides={'weight_quant': 'int4',
                                                    'kv_quant': 'int8'})
        generate_speculative(evo4.model, tok, prompt=prompts18[
            'non-repetitive'][:200], num_tokens=12, gamma=8)
        for gamma in (3, 8):
            toks, logps, _ = generate_speculative(
                evo4.model, tok, prompt=prompts18['repetitive'],
                num_tokens=32, gamma=gamma)
            teacher_forced(f'phase18_int4_int8kv_g{gamma}', evo4.model,
                           prompts18['repetitive'], toks, logps)

    out = dict(root=root, card=subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip(), draws=args.draws,
        first_seed=args.first_seed, seconds=time.time() - t_start,
        all_below_median=all(c['below_median'] for c in checks.values()),
        checks=checks)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
