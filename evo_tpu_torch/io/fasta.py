"""FASTA reading and writing (the port's own copy of
`evo_tpu/io/fasta.py`): a dependency-free parser with the observable
behaviour of BioPython's `SeqIO.parse`, the native scanner of
`io/fastio.py` under `read_fasta` where it builds, and a writer.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Tuple


def iter_fasta(path_or_handle) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) pairs. `name` is the full header sans '>'."""
    if hasattr(path_or_handle, 'read'):
        handle = path_or_handle
        close = False
    elif str(path_or_handle).endswith('.gz'):
        import gzip
        handle = gzip.open(path_or_handle, 'rt')
        close = True
    else:
        handle = open(path_or_handle)
        close = True
    try:
        name = None
        chunks: List[str] = []
        for line in handle:
            line = line.rstrip('\n').rstrip('\r')
            if not line:
                continue
            if line.startswith('>'):
                if name is not None:
                    yield name, ''.join(chunks)
                name = line[1:].strip()
                chunks = []
            else:
                chunks.append(line.strip())
        if name is not None:
            yield name, ''.join(chunks)
    finally:
        if close:
            handle.close()


def read_fasta(path) -> Tuple[List[str], List[str]]:
    """Return (names, seqs) lists, in file order.

    A path is read by the native scanner (`io/fastio.py`, one C++ pass
    over the file) when its library is available, as in the JAX package;
    a handle, or a buffer the scanner refuses, takes the Python parser."""
    if not hasattr(path, 'read'):
        from evo_tpu_torch.io import fastio
        if fastio.available():
            try:
                return fastio.read_fasta_fast(os.fspath(path))
            except RuntimeError:        # a record count it cannot size
                pass
    names, seqs = [], []
    for n, s in iter_fasta(path):
        names.append(n)
        seqs.append(s)
    return names, seqs


def write_fasta(path, names: Iterable[str], seqs: Iterable[str],
                width: int = 0) -> None:
    """Write a FASTA file. width=0 writes each sequence on one line
    (matching the reference's writers)."""
    with open(path, 'w') as f:
        for n, s in zip(names, seqs):
            f.write(f'>{n}\n')
            if width and width > 0:
                for i in range(0, len(s), width):
                    f.write(s[i:i + width] + '\n')
            else:
                f.write(s + '\n')
