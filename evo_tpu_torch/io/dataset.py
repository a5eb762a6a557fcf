"""Packed next-token training batches from FASTA corpora (the port's
numpy copy of `evo_tpu/io/dataset.py`, on the port's own FASTA reader and
tokenizer; it yields numpy arrays, as the JAX version does).

The standard causal-LM recipe the Evo models were trained with: byte
tokens, EOS-separated documents, fixed-length packed windows.

  * **Static shapes**: every batch is exactly (batch_size, seq_len + 1)
    int32, seq_len + 1 so that position t's logits pair with the t + 1
    target inside `training.next_token_loss` without wasting the last
    position.
  * **Packing, not padding**: records are tokenized (byte-level), each
    terminated with EOS (eod_id 0), concatenated, and sliced into
    contiguous windows. Only the stream's tail is padded, and the pad is
    masked out of the loss.
  * **Deterministic shuffling**: the record order is a permutation seeded
    by (seed, epoch), so a run restarts from (seed, epoch, step) alone.
  * **Sharding across processes**: windows are dealt round-robin by
    (process_index, process_count) before batching, so each process feeds
    its own data-parallel shard.

A corpus is tokenized once into one in-memory int32 stream per epoch
(gzip FASTAs are read by `iter_fasta`).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from evo_tpu_torch.io.fasta import iter_fasta
from evo_tpu_torch.tokenizer import CharLevelTokenizer


class PackedFastaDataset:
    """EOS-separated, packed, shuffled next-token batches from FASTAs.

    Yields (ids (B, seq_len+1) int32, loss_mask (B, seq_len+1) float32)
    — loss_mask[t] gates the prediction OF position t (the
    `next_token_loss` convention); only tail padding is masked out.
    """

    def __init__(self, fasta_paths: Sequence[str],
                 tokenizer: Optional[CharLevelTokenizer] = None,
                 seq_len: int = 8192, batch_size: int = 1,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if isinstance(fasta_paths, str):
            fasta_paths = [fasta_paths]
        if not fasta_paths:
            raise ValueError('no FASTA paths given')
        if process_count < 1 or not (0 <= process_index < process_count):
            raise ValueError(
                f'bad process shard {process_index}/{process_count}')
        self.tokenizer = tokenizer or CharLevelTokenizer(512)
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.process_index = process_index
        self.process_count = process_count
        self._records: List[np.ndarray] = []
        for path in fasta_paths:
            for _name, seq in iter_fasta(path):
                toks = np.asarray(self.tokenizer.tokenize(seq),
                                  dtype=np.int32)
                if toks.size:
                    self._records.append(toks)
        if not self._records:
            raise ValueError(f'no sequences found in {list(fasta_paths)}')
        self.eos = int(self.tokenizer.eos_id)
        self.pad = int(self.tokenizer.pad_id)

    @property
    def tokens_per_epoch(self) -> int:
        """Stream length: every record plus its EOS separator."""
        return sum(r.size + 1 for r in self._records)

    def epoch_windows(self, epoch: int) -> np.ndarray:
        """All (n_windows, seq_len+1) windows of one epoch's shuffled,
        EOS-joined stream (this host's shard only)."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self._records))
        stream = np.concatenate(
            [np.concatenate([self._records[i],
                             np.asarray([self.eos], np.int32)])
             for i in order])
        W = self.seq_len + 1
        n_windows = -(-stream.size // W)
        padded = np.full(n_windows * W, self.pad, np.int32)
        padded[:stream.size] = stream
        windows = padded.reshape(n_windows, W)
        mask = np.zeros((n_windows, W), np.float32)
        flat_mask = mask.reshape(-1)
        flat_mask[:stream.size] = 1.0
        keep = np.arange(n_windows) % self.process_count \
            == self.process_index
        self._epoch_mask = mask[keep]
        return windows[keep]

    def iter_batches(self, epochs: Optional[int] = None, start_epoch: int = 0
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (ids, loss_mask) batches; epochs=None loops forever.

        Ragged final windows of an epoch are DROPPED below batch_size
        (static shapes beat a sliver of extra data)."""
        epoch = start_epoch
        while epochs is None or epoch < start_epoch + epochs:
            windows = self.epoch_windows(epoch)
            masks = self._epoch_mask
            B = self.batch_size
            if len(windows) < B:
                # fail loud: with epochs=None a zero-batch epoch would
                # otherwise spin forever (re-shuffling and yielding
                # nothing) while the training loop waits for a batch
                raise ValueError(
                    f'corpus too small: epoch has {len(windows)} '
                    f'window(s) of seq_len={self.seq_len} on this host '
                    f'but batch_size={self.batch_size}; lower '
                    '--seq-len/--batch-size or add data')
            for i in range(0, len(windows) - B + 1, B):
                yield windows[i:i + B], masks[i:i + B]
            epoch += 1

    def steps_per_epoch(self) -> int:
        n = -(-self.tokens_per_epoch // (self.seq_len + 1))
        mine = len(np.arange(n)[np.arange(n) % self.process_count
                                == self.process_index])
        return mine // self.batch_size
