"""One-command numerical-parity harness against the reference
implementation (the twin of the JAX package's `scripts/verify_parity.py`,
running the PyTorch port).

The reference outputs (logits, per-sequence scores, greedy generation on
`examples/example_seqs.fasta`) come from a snapshot this repository does
not hold, so the check ships as a harness that runs once one is staged:

  1. On any machine with the reference stack (GPU + `evo` +
     stripedhyena), emit the golden outputs:

        python -m evo_tpu_torch.cli.verify_parity \
            --write-reference-script ref_emit.py
        python ref_emit.py --model-name evo-1-8k-base --out ref.npz

  2. Here, against the same safetensors snapshot:

        python -m evo_tpu_torch.cli.verify_parity \
            --checkpoint /path/to/snapshot --reference-npz ref.npz

     Prints a schema-validation report (every missing, unexpected or
     mismatched tensor at once), the config fields adapted from the
     checkpoint's shapes, and a PASS / FAIL table for logits, mean and sum
     scores and greedy token ids.

Without `--reference-npz` it emits the port's outputs (`--emit-npz`) for
later comparison; `--random-init` runs the harness end to end with no
weights. The npz layout is the JAX harness's (the same keys, float32
logits, uint8 token ids), so an npz written by either harness is read by
the other. `--fingerprint` / `--fingerprint-ref` go through the port's
`checkpoint.fingerprint_params` (names are the port's parameters).
`--device` (default cuda) places the model; `--tiny --device cpu` runs a
tiny model of the same schema.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

_DEF_FASTA = 'examples/example_seqs.fasta'

# Standalone script to run inside the *reference* environment, kept as
# data so that the harness is one file; the JAX harness's, byte for byte
_REFERENCE_EMITTER = '''\
"""Emit golden parity outputs from the reference evo implementation.

Run in the reference environment (GPU):
    python ref_emit.py --model-name evo-1-8k-base --out ref.npz
"""
import argparse

import numpy as np
import torch

from evo import Evo, generate, score_sequences
from evo.scoring import prepare_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-name', default='evo-1-8k-base')
    ap.add_argument('--fasta', default='examples/example_seqs.fasta')
    ap.add_argument('--out', default='ref.npz')
    ap.add_argument('--device', default='cuda:0')
    ap.add_argument('--greedy-tokens', type=int, default=32)
    args = ap.parse_args()

    seqs = []
    with open(args.fasta) as f:
        cur = None
        for line in f:
            line = line.strip()
            if line.startswith('>'):
                cur = ''
                seqs.append(cur)
            elif line:
                seqs[-1] += line

    evo = Evo(args.model_name)
    model, tokenizer = evo.model, evo.tokenizer
    model.to(args.device)
    model.eval()

    out = {'seqs': np.array(seqs)}
    with torch.inference_mode():
        for i, s in enumerate(seqs):
            ids, _ = prepare_batch([s], tokenizer, prepend_bos=True,
                                   device=args.device)
            logits, _ = model(ids)
            out[f'logits_{i}'] = logits.float().cpu().numpy()[0]
    out['scores_mean'] = np.array(score_sequences(
        seqs, model, tokenizer, device=args.device, reduce_method='mean'))
    out['scores_sum'] = np.array(score_sequences(
        seqs, model, tokenizer, device=args.device, reduce_method='sum'))
    gen, _ = generate(['ACGT'], model, tokenizer,
                      n_tokens=args.greedy_tokens, temperature=0.0,
                      top_k=1, device=args.device, verbose=0)
    out['greedy_ids'] = np.frombuffer(gen[0].encode(), dtype=np.uint8)
    np.savez(args.out, **out)
    print(f'wrote {args.out}: {sorted(out)}')


if __name__ == '__main__':
    main()
'''



def read_fasta_seqs(path):
    from evo_tpu_torch.io.fasta import read_fasta
    return read_fasta(path)[1]


def compute_outputs(model, tokenizer, seqs, greedy_tokens):
    """The port's side of the golden outputs (the reference emitter's
    keys)."""
    from evo_tpu_torch.generation import generate
    from evo_tpu_torch.scoring import prepare_batch, score_sequences

    out = {'seqs': np.array(seqs)}
    for i, s in enumerate(seqs):
        ids, _ = prepare_batch([s], tokenizer, prepend_bos=True)
        with torch.no_grad():
            logits, _ = model(torch.as_tensor(ids, device=model.device))
        out[f'logits_{i}'] = logits.float().cpu().numpy()[0]
    out['scores_mean'] = np.array(score_sequences(
        seqs, model, tokenizer, reduce_method='mean'))
    out['scores_sum'] = np.array(score_sequences(
        seqs, model, tokenizer, reduce_method='sum'))
    gen, _ = generate(['ACGT'], model, tokenizer, n_tokens=greedy_tokens,
                      temperature=0.0, top_k=1, verbose=0)
    out['greedy_ids'] = np.frombuffer(gen[0].encode(), dtype=np.uint8)
    return out


def compare(ours, ref, tol):
    """PASS / FAIL rows for every golden key; returns the overall pass."""
    rows = []
    n_logits = sum(1 for k in ref if k.startswith('logits_'))
    for i in range(n_logits):
        a, b = ours[f'logits_{i}'], ref[f'logits_{i}']
        if a.shape != b.shape:
            rows.append((f'logits[{i}]', False, f'shape {a.shape}!={b.shape}'))
            continue
        d = float(np.max(np.abs(a - b)))
        rows.append((f'logits[{i}]', d <= tol, f'max|diff|={d:.3e}'))
    for key in ('scores_mean', 'scores_sum'):
        if key not in ref:
            continue
        d = float(np.max(np.abs(ours[key] - ref[key])))
        rows.append((key, d <= tol, f'max|diff|={d:.3e}'))
    if 'greedy_ids' in ref:
        same = np.array_equal(ours['greedy_ids'], ref['greedy_ids'])
        n = min(len(ours['greedy_ids']), len(ref['greedy_ids']))
        agree = int(np.sum(ours['greedy_ids'][:n] == ref['greedy_ids'][:n]))
        rows.append(('greedy_ids', same, f'{agree}/{n} tokens agree'))
    ok = all(p for _, p, _ in rows)
    width = max(len(r[0]) for r in rows)
    for name, p, detail in rows:
        print(f'  {name:<{width}}  {"PASS" if p else "FAIL"}  {detail}')
    return ok


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--checkpoint', default=None,
                    help='local HF safetensors snapshot (reference format)')
    ap.add_argument('--model-name', default='evo-1-8k-base')
    ap.add_argument('--fasta', default=_DEF_FASTA)
    ap.add_argument('--reference-npz', default=None)
    ap.add_argument('--emit-npz', default=None)
    ap.add_argument('--tolerance', type=float, default=1e-3)
    ap.add_argument('--greedy-tokens', type=int, default=32)
    ap.add_argument('--random-init', action='store_true',
                    help='harness self-test with random weights')
    ap.add_argument('--tiny', action='store_true',
                    help='tiny model of the same schema (CPU smoke tests; '
                         'implies --random-init)')
    ap.add_argument('--device', default='cuda',
                    help='where the model runs: cuda (default) or cpu')
    ap.add_argument('--write-reference-script', default=None, metavar='PATH',
                    help='write the reference-side golden emitter and exit')
    ap.add_argument('--fingerprint', default=None, metavar='OUT_JSON',
                    help="write the loaded model's numeric fingerprint "
                         '(per-tensor l2 / mean and a permutation-sensitive '
                         'projection, checkpoint.fingerprint_params): '
                         'record it at conversion so that a later layout '
                         'change shows without reference outputs')
    ap.add_argument('--fingerprint-ref', default=None, metavar='REF_JSON',
                    help='compare the loaded model against a recorded '
                         'fingerprint; FAIL lists every mismatched tensor '
                         '(a same-norm, different-proj row is the '
                         'wrong-layout signature)')
    ap.add_argument('--manifest', action='store_true',
                    help='print the expected tensor-shape manifest of '
                         'every registry checkpoint (no snapshot needed) '
                         'and the reconstructed-layout caveats, then exit')
    return ap


def main(argv: Optional[List[str]] = None):
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.manifest:
        from evo_tpu_torch import checkpoint as ckpt
        from evo_tpu_torch.models import MODEL_NAMES, config_for_model
        for name in MODEL_NAMES:
            cfg = config_for_model(name)
            spec = ckpt.expected_state_dict_spec(cfg)
            n_params = sum(int(np.prod(s)) for s in spec.values())
            print(f'{name}: {len(spec)} tensors, {n_params:,} params')
            for k in sorted(spec):
                print(f'  {k}  {tuple(spec[k])}')
        print()
        print('layout assumptions NOT provable by shape alone '
              '(checkpoint.RECONSTRUCTED_LAYOUTS):')
        for k, v in ckpt.RECONSTRUCTED_LAYOUTS.items():
            print(f'  {k}: {v}')
        return 0

    if args.write_reference_script:
        with open(args.write_reference_script, 'w') as f:
            f.write(_REFERENCE_EMITTER)
        print(f'wrote {args.write_reference_script}; run it in the '
              f'reference environment to produce --reference-npz input')
        return 0

    from evo_tpu_torch import checkpoint as ckpt
    from evo_tpu_torch.config import cli_tiny_overrides
    from evo_tpu_torch.models import Evo, config_for_model

    if args.tiny:
        args.random_init = True
    if not args.random_init:
        if not args.checkpoint:
            ap.error('--checkpoint (or --random-init) is required')
        # the whole schema report before any conversion
        cfg = config_for_model(args.model_name)
        sd = ckpt.strip_backbone_prefix(
            ckpt.read_safetensors_state_dict(args.checkpoint))
        ovr = ckpt.infer_config_overrides(sd, cfg)
        if ovr:
            print(f'config fields adapted from checkpoint shapes: '
                  f'{json.dumps(ovr)}')
            cfg = cfg.replace(**ovr)
        report = ckpt.validate_state_dict(sd, cfg)
        print(ckpt.format_validation_report(report))
        if not report['ok']:
            return 2
        del sd

    evo = Evo(args.model_name, args.device, checkpoint_path=args.checkpoint,
              random_init=args.random_init,
              config_overrides=cli_tiny_overrides() if args.tiny else None)

    if args.fingerprint or args.fingerprint_ref:
        fp = ckpt.fingerprint_params(evo.model.module)
        if args.fingerprint:
            with open(args.fingerprint, 'w') as f:
                json.dump(fp, f, indent=1)
            print(f'wrote fingerprint ({len(fp)} leaves) to '
                  f'{args.fingerprint}')
        if args.fingerprint_ref:
            with open(args.fingerprint_ref) as f:
                want = json.load(f)
            problems = ckpt.compare_fingerprints(fp, want)
            if problems:
                print(f'fingerprint: FAIL ({len(problems)} leaves)')
                for p in problems[:40]:
                    print(f'  {p}')
                return 1
            print(f'fingerprint: PASS ({len(fp)} leaves match)')
        if not (args.reference_npz or args.emit_npz):
            return 0

    seqs = read_fasta_seqs(args.fasta)
    print(f'computing outputs for {len(seqs)} sequences + '
          f'{args.greedy_tokens}-token greedy generation...')
    ours = compute_outputs(evo.model, evo.tokenizer, seqs,
                           args.greedy_tokens)

    if args.emit_npz:
        np.savez(args.emit_npz, **ours)
        print(f'wrote {args.emit_npz}')
    if args.reference_npz:
        ref = dict(np.load(args.reference_npz, allow_pickle=False))
        ok = compare(ours, ref, args.tolerance)
        print(f'parity: {"PASS" if ok else "FAIL"} '
              f'(tolerance {args.tolerance})')
        return 0 if ok else 1
    if not args.emit_npz:
        print('no --reference-npz given; pass --emit-npz to save outputs')
    return 0


if __name__ == '__main__':
    sys.exit(main())
