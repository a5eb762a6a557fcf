"""Batched log-likelihood scoring (port of `evo_tpu/scoring.py`).

Reference numerics: right padding with pad_id and NO mask inside the model;
padding is harmless because every mixer is causal, and outputs are sliced
to the true lengths afterwards. Segmented long-sequence scoring is not
ported yet: its two entry points raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from evo_tpu_torch.tokenizer import CharLevelTokenizer


def prepare_batch(seqs: Sequence[str], tokenizer: CharLevelTokenizer,
                  prepend_bos: bool = True) -> Tuple[np.ndarray, List[int]]:
    """Tokenize, optionally prepend BOS (= eod id 0), right-pad with
    pad_id. Returns (input_ids (B, L) int32, seq_lengths)."""
    seq_lengths = [len(s) for s in seqs]
    max_len = max(seq_lengths) + int(prepend_bos)
    batch = np.full((len(seqs), max_len), tokenizer.pad_id, dtype=np.int32)
    off = int(prepend_bos)
    for i, s in enumerate(seqs):
        toks = tokenizer.tokenize(s)
        if off:
            batch[i, 0] = tokenizer.eod_id
        batch[i, off:off + len(toks)] = toks
    return batch, seq_lengths


def logits_to_logprobs(logits: torch.Tensor, input_ids,
                       trim_bos: bool = True) -> torch.Tensor:
    """Log-likelihood of `input_ids` (B, L) under `logits` (B, L, V), in
    float32. With trim_bos, position t's logits score token t+1: (B, L-1).
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    ids = torch.as_tensor(input_ids, device=logits.device).long()
    if trim_bos:
        logp = logp[:, :-1]
        ids = ids[:, 1:]
    if logp.shape[1] != ids.shape[1]:
        raise ValueError(f'logits cover {logp.shape[1]} positions, ids '
                         f'{ids.shape[1]}')
    return torch.gather(logp, -1, ids[..., None])[..., 0]


def _reduce(reduce_method: str):
    if reduce_method == 'mean':
        return np.mean
    if reduce_method == 'sum':
        return np.sum
    raise ValueError(f'Invalid reduce_method {reduce_method}')


def score_sequences(seqs: Sequence[str], model, tokenizer: CharLevelTokenizer,
                    reduce_method: str = 'mean',
                    prepend_bos: bool = True) -> List[float]:
    """Mean (or summed) log-likelihood of each sequence. `model` follows the
    engine call contract `model(input_ids) -> (logits, None)`."""
    reduce_func = _reduce(reduce_method)
    input_ids, seq_lengths = prepare_batch(seqs, tokenizer,
                                           prepend_bos=prepend_bos)
    logits, _ = model(input_ids)
    # the reference trims even without BOS: the trim pairs position t's
    # logits with the t+1 target
    logprobs = logits_to_logprobs(logits, input_ids).cpu().numpy()
    return [float(reduce_func(logprobs[i][:n]))
            for i, n in enumerate(seq_lengths)]


def positional_entropies(seqs: Sequence[str], model,
                         tokenizer: CharLevelTokenizer,
                         prepend_bos: bool = True) -> List[np.ndarray]:
    """Per-position Shannon entropy of the predictive distribution,
    trimmed to each true sequence length."""
    input_ids, seq_lengths = prepare_batch(seqs, tokenizer,
                                           prepend_bos=prepend_bos)
    logits, _ = model(input_ids)
    logp = torch.log_softmax(logits.float(), dim=-1)
    if prepend_bos:
        logp = logp[:, :-1]
    ent = (-torch.sum(torch.exp(logp) * logp, dim=-1)).cpu().numpy()
    return [ent[i][:n] for i, n in enumerate(seq_lengths)]


_SEGMENTED_TODO = ('segmented scoring is not ported yet (ROADMAP.md, '
                   'modules queue: resumed prefill with the '
                   'flash_attention_buffer kernel)')


def score_sequences_segmented(*args, **kwargs):
    """Long-sequence scoring in segments through the resumed prefill."""
    raise NotImplementedError(_SEGMENTED_TODO)


def positional_entropies_segmented(*args, **kwargs):
    """Long-sequence entropies in segments through the resumed prefill."""
    raise NotImplementedError(_SEGMENTED_TODO)


def _aligned_cache_len(L: int, align: int = 1024) -> int:
    """KV-buffer length for a sequence of L positions: L + 1, rounded up to
    `align` for L >= 4096 and to 128 below, as in the JAX package."""
    T = L + 1
    if L >= 4096:
        return -(-T // align) * align
    return -(-T // 128) * 128
