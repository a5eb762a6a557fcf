"""End-to-end demo: generate DNA with Evo -> call genes with prodigal ->
fold the predicted proteins with ESMFold (the twin of the JAX package's
`scripts/generation_to_folding.py`: the same flags and artifact files,
a sequence FASTA, a proteins FASTA and a PDB per protein), generating
through the PyTorch port.

    python -m evo_tpu_torch.cli.generation_to_folding \
        --prompt "|d__Bacteria;p__Pseudomonadota;...|" \
        --model-name evo-1-131k-base --checkpoint-path /path/to/snapshot \
        --max-new-tokens 1024

prodigal runs as a subprocess (it must be on PATH); ESMFold comes from
the `transformers` package, which fetches `facebook/esmfold_v1` from the
Hugging Face hub unless it is cached; `--skip-folding` stops after
prodigal. `--device` (default cuda) places Evo, `--esmfold-device`
ESMFold; `--tiny --device cpu` runs a tiny Evo of the same schema.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from typing import List, Optional

from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.generation import generate
from evo_tpu_torch.io.fasta import iter_fasta, write_fasta
from evo_tpu_torch.models import Evo

DEFAULT_PROMPT = ('|d__Bacteria;p__Pseudomonadota;c__Gammaproteobacteria;'
                  'o__Enterobacterales;f__Enterobacteriaceae;'
                  'g__Escherichia;s__Escherichia|')


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description='Generate DNA with Evo, call '
                                 'genes with prodigal, fold with ESMFold.')
    ap.add_argument('--prompt', type=str, default=DEFAULT_PROMPT)
    ap.add_argument('--model-name', type=str, default='evo-1-131k-base')
    ap.add_argument('--temperature', type=float, default=1.0)
    ap.add_argument('--top-k', type=int, default=4)
    ap.add_argument('--top-p', type=float, default=1.0)
    ap.add_argument('--cached-generation', action='store_true',
                    default=True,
                    help='accepted for reference-CLI parity; decode is '
                         'always cached')
    ap.add_argument('--max-new-tokens', type=int, default=1024)
    ap.add_argument('--sequence-fasta', type=str, default='sequence.fasta')
    ap.add_argument('--proteins-fasta', type=str, default='proteins.fasta')
    ap.add_argument('--structure-pdb', type=str, default='structure.pdb')
    ap.add_argument('--device', type=str, default='cuda',
                    help='where Evo runs: cuda (default) or cpu')
    ap.add_argument('--esmfold-device', type=str, default='cpu')
    ap.add_argument('--verbose', type=int, default=1)
    ap.add_argument('--seed', type=int, default=12345)
    ap.add_argument('--checkpoint-path', default=None)
    ap.add_argument('--random-init', action='store_true')
    ap.add_argument('--tiny', action='store_true',
                    help='tiny Evo of the same schema (CPU smoke tests; '
                         'implies --random-init)')
    ap.add_argument('--skip-folding', action='store_true',
                    help='stop after prodigal (no ESMFold download)')
    return ap


def fold(proteins_fasta: str, structure_pdb: str, device: str) -> List[str]:
    """Fold every protein of `proteins_fasta` with ESMFold; one PDB a
    protein, named after `structure_pdb` and the protein's id. Returns the
    paths written."""
    import torch
    from transformers import AutoTokenizer, EsmForProteinFolding

    print('Loading ESMFold...')
    esmfold = EsmForProteinFolding.from_pretrained('facebook/esmfold_v1')
    esmfold = esmfold.to(device)
    if device != 'cpu':
        esmfold.esm = esmfold.esm.half()
    tok = AutoTokenizer.from_pretrained('facebook/esmfold_v1')

    print('Folding proteins with ESMFold...')
    written = []
    for name, protein in iter_fasta(proteins_fasta):
        protein_seq = protein.rstrip('*')
        print('Protein sequence: ', protein_seq)
        with torch.inference_mode():
            inputs = tok([protein_seq], return_tensors='pt',
                         add_special_tokens=False).to(device)
            out = esmfold(**inputs)
            pdb = esmfold.output_to_pdb(out)[0]
        # one PDB per protein (a single shared path would keep only the
        # last protein's structure)
        base, ext = os.path.splitext(structure_pdb)
        safe = name.split()[0].replace('/', '_')
        out_path = f'{base}_{safe}{ext or ".pdb"}'
        with open(out_path, 'w') as f:
            f.write(pdb)
        print('Saved structure to: ', out_path)
        written.append(out_path)
    return written


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init or args.tiny,
              config_overrides=cli_tiny_overrides() if args.tiny else None)

    print('Generating...')
    seqs, _scores = generate(
        [args.prompt], evo.model, evo.tokenizer,
        n_tokens=args.max_new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, cached_generation=True,
        seed=args.seed, verbose=args.verbose)
    dna_seq = seqs[0]
    print('Generated DNA sequence: ', dna_seq)

    write_fasta(args.sequence_fasta, ['evo-dna DNA sequence generated by '
                                      'Evo.'], [dna_seq])
    print('Saved DNA sequence to: ', args.sequence_fasta)

    print('Predicting genes with prodigal...')
    prodigal = shutil.which('prodigal')
    if not prodigal:
        raise FileNotFoundError('prodigal not found on PATH')
    subprocess.run([prodigal, '-i', args.sequence_fasta, '-a',
                    args.proteins_fasta, '-o', 'genes.gbk', '-p', 'meta'],
                   check=True)

    if args.skip_folding:
        print('Skipping folding (--skip-folding).')
        return dna_seq, []
    return dna_seq, fold(args.proteins_fasta, args.structure_pdb,
                         args.esmfold_device)


if __name__ == '__main__':
    main()
