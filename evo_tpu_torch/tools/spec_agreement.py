"""Teacher-forcing agreement of greedy decoding and of speculative
decoding, n-gram and oracle-drafted, on one CUDA card, for the checkout
at --root:

    python3 evo_tpu_torch/tools/spec_agreement.py --root . \\
        [--weight-quant int4] [--kv-quant int8] [--tokens 32 96]

A random-init evo-1-131k-base (seed 0) under the given quantized modes,
and `chip_smoke.py` phase 18's two 512-nt prompts (a tandem repeat of a
64-nt unit and a random sequence, from seed 18). For each prompt and
token count: greedy `Generator` decoding, `generate_speculative` with the
n-gram drafter at g = 3 and 8, and with `OracleDrafter` at g = 3 and 8
(`SCHEDULES`). Prints one JSON line a run: the acceptance,
the mean |log-prob - forward's| over the generated tokens (`d`), the same
for the forward with one bf16 rounding step (a relative 2^-8 of random
sign) on layer 0's first norm (`f`, phase 5's yardstick), the greedy
argmax agreement with the forward (`agree`), the nudged forward's own
argmax agreement with the forward (`nudged_agree`: what one rounding does
to the argmax), and the forward's log-prob gap between its argmax and the
emitted token at each disagreement (`gaps`).
"""

import argparse
import contextlib
import collections
import json
import os
import sys
import time

import numpy as np


class OracleDrafter:
    """A drafter for `generate_speculative` that proposes the model's
    greedy continuation of what the loop has emitted, made wrong at
    position schedule[c] of cycle c (right throughout where schedule[c] >=
    gamma): cycles that accept in full, in part and not at all, on random
    weights where the n-gram index is never right. The continuation comes
    from the greedy `Generator` (decode steps) and is worked out anew
    wherever the loop's verify-pass argmax left it (a near-tie the two
    paths round apart). Its launches (`ops._build.LAUNCHES`) and seconds
    are counted apart, so a caller can take them out of a run's own.
    `with drafter.installed():` puts it in place of `NGramIndex.propose`.
    """

    def __init__(self, model, tokenizer, prompt_len, schedule):
        from evo_tpu_torch.generation import Generator
        self.gen = Generator(model, tokenizer, top_k=1, temperature=0.0)
        self.P, self.schedule, self.cycle = prompt_len, schedule, 0
        self.ref, self.anchors, self.seconds = [], 0, 0.0
        self.launches = collections.Counter()

    def _sync(self):
        import torch
        if self.gen.model.device.type == 'cuda':
            torch.cuda.synchronize()

    def propose(self, index, gamma):
        from evo_tpu_torch.ops import _build
        done = [int(t) for t in index.tokens[self.P:]]
        if self.ref[:len(done)] != done or len(self.ref) < len(done) + gamma:
            self._sync()
            before, t = collections.Counter(_build.LAUNCHES), time.time()
            cont, _, _ = self.gen.generate(
                input_ids=np.asarray(index.tokens, np.int64)[None],
                num_tokens=2 * gamma)
            self.ref = done + cont[0].tolist()
            self._sync()
            self.seconds += time.time() - t
            self.launches += collections.Counter(_build.LAUNCHES)
            self.launches.subtract(before)
            self.anchors += 1
        props = self.ref[len(done):len(done) + gamma]
        a = self.schedule[self.cycle % len(self.schedule)]
        self.cycle += 1
        if a < gamma:
            props[a] = (props[a] + 1) % 512            # never the argmax
        return np.asarray(props, np.int32)

    @contextlib.contextmanager
    def installed(self):
        from evo_tpu_torch import speculative
        real = speculative.NGramIndex.propose
        speculative.NGramIndex.propose = (
            lambda index, gamma: self.propose(index, gamma))
        try:
            yield self
        finally:
            speculative.NGramIndex.propose = real


SCHEDULES = {3: [3, 3, 2, 3, 1, 0], 8: [5, 8, 6, 2, 0, 8]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default='.')
    ap.add_argument('--weight-quant', default='none')
    ap.add_argument('--kv-quant', default='none')
    ap.add_argument('--tokens', type=int, nargs='+', default=[32, 96])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from evo_tpu_torch import generate_speculative
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import Evo

    dev = torch.device('cuda')
    rng = np.random.default_rng(18)
    unit = ''.join(rng.choice(list('ACGT'), 64))
    prompts = {'repetitive': unit * 8,
               'non-repetitive': ''.join(rng.choice(list('ACGT'), 512))}
    sign = torch.randint(0, 2, (1, 1, 4096), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    evo = Evo('evo-1-131k-base', random_init=True, seed=0, device='cuda',
              config_overrides={'weight_quant': args.weight_quant,
                                'kv_quant': args.kv_quant})
    model, tok = evo.model, evo.tokenizer

    def teacher_forced(prompt, toks, logps):
        P = len(prompt)
        full = torch.as_tensor(np.concatenate([tok.tokenize(prompt), toks]),
                               device=dev).long()[None]
        nxt = full[0, P:]
        ref = torch.log_softmax(model(full)[0][0, P - 1:-1].float(), -1)
        hook = model.module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, o: o * (1 + (2 * sign - 1) * 2.0 ** -8)
            .to(o.dtype))
        nud = torch.log_softmax(model(full)[0][0, P - 1:-1].float(), -1)
        hook.remove()
        lp = ref.gather(-1, nxt[:, None])[:, 0]
        miss = ref.argmax(-1) != nxt
        return dict(
            d=float((torch.as_tensor(logps, device=dev) - lp).abs().mean()),
            f=float((nud.gather(-1, nxt[:, None])[:, 0] - lp).abs().mean()),
            agree=float((~miss).float().mean()),
            nudged_agree=float((nud.argmax(-1) == ref.argmax(-1)).float()
                               .mean()),
            gaps=[round(float(x), 4)
                  for x in (ref.max(-1).values - lp)[miss]])

    card = torch.cuda.get_device_name(0)
    for n in args.tokens:
        for label, prompt in prompts.items():
            ids = np.asarray(tok.tokenize(prompt))[None]
            toks, scores, _ = Generator(model, tok, top_k=1,
                                        temperature=0.0).generate(
                input_ids=ids, num_tokens=n)
            lp = torch.log_softmax(scores[0].float(), -1).gather(
                -1, toks[0][:, None].long())[:, 0]
            runs = [('greedy', None, toks[0].cpu().numpy(), lp.tolist())]
            for g in (3, 8):
                for drafter in ('ngram', 'oracle'):
                    oracle = (OracleDrafter(model, tok, len(prompt),
                                            SCHEDULES[g])
                              if drafter == 'oracle' else None)
                    with (oracle.installed() if oracle
                          else contextlib.nullcontext()):
                        t, lps, stats = generate_speculative(
                            model, tok, prompt=prompt, num_tokens=n,
                            gamma=g)
                    runs.append((f'{drafter} g={g}', stats, t, lps))
            for name, stats, t, lps in runs:
                print(json.dumps(dict(
                    card=card, weight_quant=args.weight_quant,
                    kv_quant=args.kv_quant,
                    tokens=n, prompt=label, run=name,
                    acceptance=stats.acceptance_rate if stats else None,
                    **teacher_forced(prompt, t, lps))), flush=True)


if __name__ == '__main__':
    main()
