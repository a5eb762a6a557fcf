"""Biology constants and small host-side helpers (the port's own copy of
`evo_tpu/utils.py`).

The port cannot import that module: importing anything under `evo_tpu`
runs `evo_tpu/__init__.py`, which imports JAX. The contents are the same,
function for function: the NTs / AAs constants, the codon tables generated
from the standard genetic code (the reference's hand-typed table at
`evo/utils.py:17` has an RNA-alphabet typo, 'GGU', which neither package
reproduces), `reverse_complement`, the deep mutational scan generator, the
BLAST / ERPIN / hmmsearch parsers (pandas, imported where they run) and
the permutation test.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

NTs = 'ACGT'
AAs = 'ACDEFGHIKLMNPQRSTVWY'

# Standard genetic code: 64 codons in TCAG-major order.
_BASES = 'TCAG'
_CODE = ('FFLLSSSSYY**CC*W'   # TTT..TGG
         'LLLLPPPPHHQQRRRR'   # CTT..CGG
         'IIIMTTTTNNKKSSRR'   # ATT..AGG
         'VVVVAAAADDEEGGGG')  # GTT..GGG

CODON_TO_AA: Dict[str, str] = {
    a + b + c: _CODE[i * 16 + j * 4 + k]
    for i, a in enumerate(_BASES)
    for j, b in enumerate(_BASES)
    for k, c in enumerate(_BASES)
}

AA_TO_CODON: Dict[str, List[str]] = {}
for _codon, _aa in CODON_TO_AA.items():
    AA_TO_CODON.setdefault(_aa, []).append(_codon)

AA_3_TO_1 = {
    'Ala': 'A', 'Arg': 'R', 'Asn': 'N', 'Asp': 'D', 'Cys': 'C',
    'Gln': 'Q', 'Glu': 'E', 'Gly': 'G', 'His': 'H', 'Ile': 'I',
    'Leu': 'L', 'Lys': 'K', 'Met': 'M', 'Phe': 'F', 'Pro': 'P',
    'Ser': 'S', 'Thr': 'T', 'Trp': 'W', 'Tyr': 'Y', 'Val': 'V',
}

_COMPLEMENT = str.maketrans('ACGTNacgtn', 'TGCANtgcan')


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def nucleotide_deep_mutational_scan(
        sequence: str, ignore_wt: bool = True
) -> Iterator[Tuple[str, str, int]]:
    """Yield (wt, mt, idx) for every single-nucleotide substitution."""
    for idx, wt in enumerate(sequence):
        for mt in NTs:
            if ignore_wt and wt == mt:
                continue
            yield (wt, mt, idx)


def parse_blast_output(output_path: str):
    """Parse BLAST `-outfmt 6` tabular output into a DataFrame."""
    import pandas as pd
    # 12 fields: the reference parser lists only 11 and silently drops
    # bitscore (evo/utils.py:77-80); keeping it is a strict superset
    cols = ['qacc', 'sacc', 'pident', 'length', 'mismatch', 'gapopen',
            'qstart', 'qend', 'sstart', 'send', 'evalue', 'bitscore']
    rows = []
    with open(output_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            rows.append(dict(zip(cols, line.split())))
    df = pd.DataFrame(rows)
    if len(df):
        df['evalue'] = df['evalue'].astype(float)
    return df


def parse_erpin_output(output_path: str, name: str):
    """Parse ERPIN hit records for `name` into a DataFrame."""
    import pandas as pd
    fields = ['strand', 'index', 'interval', 'score', 'evalue']
    rows = []
    with open(output_path) as f:
        for line in f:
            if line.startswith(f'>{name}'):
                meta = dict(zip(fields, f.readline().rstrip().split()))
                sequence = f.readline().rstrip()
                start, end = meta['interval'].split('..')
                rows.append([
                    f"{name}_{meta['index']}_{meta['strand']}",
                    sequence, int(start), int(end),
                    '+' if meta['strand'] == 'FW' else '-',
                    meta['score'], float(meta['evalue']),
                ])
    return pd.DataFrame(
        rows, columns=['id', 'seq', 'start', 'end', 'strand', 'score',
                       'evalue'])


def parse_hmmsearch_output(output_path: str):
    """Parse hmmsearch --domtblout style output into a DataFrame."""
    import pandas as pd
    cols = ['target', 'target_acc', 'tlen', 'query', 'query_acc', 'qlen',
            'evalue', 'score', 'bias', 'num', 'of', 'cevalue', 'ievalue',
            'dscore', 'dbias', 'hmm_from', 'hmm_to', 'ali_from', 'ali_to',
            'env_from', 'env_to', 'acc', 'desc']
    rows = []
    with open(output_path) as f:
        for line in f:
            if line.startswith('#'):
                continue
            # desc is free text (everything after column 22): cap the
            # split so multi-word descriptions survive (the
            # reference's plain split() keeps only the first word)
            rows.append(dict(zip(cols,
                                 line.strip().split(None,
                                                    len(cols) - 1))))
    return pd.DataFrame(rows)


def permutation_test(
    score_func: Callable[[np.ndarray, np.ndarray], float],
    x1, x2,
    n_permutations: int = 100_000,
    rng: np.random.Generator | None = None,
) -> float:
    """Permutation-based one-sided P value of score_func(x1, x2)."""
    if n_permutations < 1:
        raise ValueError('Number of permutations must be positive.')
    rng = rng or np.random.default_rng()
    x1, x2 = np.asarray(x1), np.asarray(x2)
    observed = score_func(x1, x2)
    null = np.array([
        score_func(x1, rng.permutation(x2)) for _ in range(n_permutations)
    ])
    return float(np.mean(null >= observed))
