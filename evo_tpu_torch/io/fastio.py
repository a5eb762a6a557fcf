"""The native FASTA scanner (the port's own copy of `evo_tpu/io/fastio.py`
and its `_fastio.cpp`): one C++ pass over a file's bytes records the
header spans and packs the sequence bytes, so a genome-scale file costs no
Python work per line. `io/fasta.read_fasta` uses it when the library is
available; the Python parser stays the fallback and the oracle (the tests
hold the two equal).

This is host code. At first use the source is compiled with the host's
compiler (`g++ -O3 -shared -fPIC`) into `evo_tpu_torch/build/`, under a
name that carries a hash of the source, so a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / '_fastio.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build'

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f'libfastio_{digest}.so'


def _build() -> Path:
    """Compile the scanner unless its library exists; written to a
    temporary name first, so processes that build at once never load a
    half-written file."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o', str(out),
                        str(SOURCE)], check=True, capture_output=True)
        os.replace(out, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.fastio_scan.restype = ctypes.c_long
            lib.fastio_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_char), ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
                ctypes.c_long]
            lib.fastio_count_records.restype = ctypes.c_long
            lib.fastio_count_records.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_long]
            _lib = lib
        except (subprocess.CalledProcessError, OSError) as e:
            sys.stderr.write(f'evo_tpu_torch.io.fastio: native build '
                             f'unavailable ({e}); using the Python FASTA '
                             f'parser\n')
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def parse_fasta_bytes(data: bytes) -> Tuple[List[str], List[str]]:
    """Parse a FASTA buffer natively -> (names, seqs).

    The Python parser's observable behaviour: full headers sans '>', line
    breaks stripped, interior spaces kept (the tokenizer's EOS), leading
    junk ignored. Raises RuntimeError when the library is missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native fastio library unavailable')
    n = len(data)
    if n == 0:
        return [], []
    max_records = int(lib.fastio_count_records(data, n))
    if max_records == 0:
        return [], []
    out_seq = ctypes.create_string_buffer(n)
    name_starts = np.empty(max_records, dtype=np.int64)
    name_ends = np.empty(max_records, dtype=np.int64)
    seq_ends = np.empty(max_records, dtype=np.int64)
    num = int(lib.fastio_scan(
        data, n, out_seq,
        name_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        name_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        seq_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        max_records))
    if num < 0:
        raise RuntimeError('fastio_scan record overflow')
    packed = out_seq.raw
    names, seqs = [], []
    prev = 0
    for i in range(num):
        names.append(data[name_starts[i]:name_ends[i]].decode(
            'utf-8', errors='replace').strip())
        end = int(seq_ends[i])
        seqs.append(packed[prev:end].decode('utf-8', errors='replace'))
        prev = end
    return names, seqs


def read_fasta_fast(path) -> Tuple[List[str], List[str]]:
    """(names, seqs) of a FASTA file, gzip-compressed or not (told by its
    magic bytes)."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:2] == b'\x1f\x8b':
        import gzip
        data = gzip.decompress(data)
    return parse_fasta_bytes(data)
