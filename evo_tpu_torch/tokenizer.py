"""Byte-level tokenizer (numpy-only copy of `evo_tpu/tokenizer.py`).

Contract of the reference CharLevelTokenizer: tokenize = raw UTF-8 bytes;
detokenize clamps ids to [32, vocab) before chr(); eod_id = eos_id = 0,
pad_id = 1; vocab_size = 512.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class CharLevelTokenizer:
    def __init__(self, vocab_size: int = 512):
        self._vocab_size = vocab_size
        self.eod_id = 0
        self.eos_id = 0
        self.pad_id = 1

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def vocab(self) -> int:  # the reference exposes both spellings
        return self._vocab_size

    def clamp(self, n: int) -> int:
        return max(32, min(n, self._vocab_size))

    def tokenize(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode('utf-8'), dtype=np.uint8).astype(
            np.int32)

    def tokenize_batch(self, texts: Sequence[str]) -> List[np.ndarray]:
        return [self.tokenize(t) for t in texts]

    def detokenize(self, ids) -> str:
        ids = np.asarray(ids).reshape(-1)
        return ''.join(chr(self.clamp(int(t))) for t in ids)

    def detokenize_batch(self, batch) -> List[str]:
        return [self.detokenize(row) for row in np.asarray(batch)]
