"""Batched log-likelihood scoring (port of `evo_tpu/scoring.py`).

Reference numerics: right padding with pad_id and NO mask inside the model;
padding is harmless because every mixer is causal, and outputs are sliced
to the true lengths afterwards. The segmented entry points prefill a long
sequence in pieces through the resumable cache, so activation memory is
that of one segment; this is the one-device path to 131k-long sequences.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from evo_tpu_torch.tokenizer import CharLevelTokenizer


def next_bucket(n: int, minimum: int = 32) -> int:
    """The smallest power-of-two multiple of `minimum` that holds n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def prepare_batch(seqs: Sequence[str], tokenizer: CharLevelTokenizer,
                  prepend_bos: bool = True, pad_to_bucket: bool = False
                  ) -> Tuple[np.ndarray, List[int]]:
    """Tokenize, optionally prepend BOS (= eod id 0), right-pad with
    pad_id, with `pad_to_bucket` up to a power-of-two length. Every mixer
    is causal, so the padding never changes earlier positions. Returns
    (input_ids (B, L) int32, seq_lengths)."""
    seq_lengths = [len(s) for s in seqs]
    max_len = max(seq_lengths) + int(prepend_bos)
    if pad_to_bucket:
        max_len = next_bucket(max_len)
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
                    reduce_method: str = 'mean', prepend_bos: bool = True,
                    pad_to_bucket: bool = False) -> List[float]:
    """Mean (or summed) log-likelihood of each sequence. `model` follows the
    engine call contract `model(input_ids) -> (logits, None)`."""
    reduce_func = _reduce(reduce_method)
    input_ids, seq_lengths = prepare_batch(
        seqs, tokenizer, prepend_bos=prepend_bos, pad_to_bucket=pad_to_bucket)
    logits, _ = model(input_ids)
    # the reference trims even without BOS: the trim pairs position t's
    # logits with the t+1 target
    logprobs = logits_to_logprobs(logits, input_ids).cpu().numpy()
    return [float(reduce_func(logprobs[i][:n]))
            for i, n in enumerate(seq_lengths)]


def score_stream(seq_batches: Iterable[Sequence[str]], model,
                 tokenizer: CharLevelTokenizer, reduce_method: str = 'mean',
                 prepend_bos: bool = True, pad_to_bucket: bool = True,
                 prefetch_depth: int = 2,
                 progress: Optional[Callable[[int], None]] = None
                 ) -> List[float]:
    """`score_sequences` over an iterable of batches, with the same
    results as scoring them one by one, and the host's work overlapped
    with the device's: a worker thread tokenizes and pads
    `prefetch_depth` batches ahead (`io/prefetch.py`; a depth below 1
    runs in line), and the log-likelihoods of batch i - 1 are read back
    only after batch i has been handed to the device (CUDA launches
    return before the work is done). `progress`, if given, is called with
    the running count of scored sequences."""
    from evo_tpu_torch.io.prefetch import prefetch_map

    reduce_func = _reduce(reduce_method)
    scores: List[float] = []

    def prep(batch):
        return prepare_batch(batch, tokenizer, prepend_bos=prepend_bos,
                             pad_to_bucket=pad_to_bucket)

    def finalize(pending):
        logprobs, seq_lengths = pending
        logprobs = logprobs.cpu().numpy()
        scores.extend(float(reduce_func(logprobs[i][:n]))
                      for i, n in enumerate(seq_lengths))
        if progress is not None:
            progress(len(scores))

    pending = None
    for input_ids, seq_lengths in prefetch_map(prep, seq_batches,
                                               depth=prefetch_depth):
        logits, _ = model(input_ids)
        logprobs = logits_to_logprobs(logits, input_ids)
        if pending is not None:
            finalize(pending)
        pending = (logprobs, seq_lengths)
    if pending is not None:
        finalize(pending)
    return scores


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


def _aligned_cache_len(L: int, align: int = 1024) -> int:
    """KV-buffer length for a sequence of L positions: L + 1, rounded up to
    `align` for L >= 4096 and to 128 below, as in the JAX package (whose
    kernel needs such lengths; the port's takes any, and keeps the rule so
    both allocate the same buffers)."""
    T = L + 1
    if L >= 4096:
        return -(-T // align) * align
    return -(-T // 128) * 128


def _cache_align(cfg) -> int:
    return 4096 if cfg.kv_quant == 'int8' else 1024


def _segment_bounds(L: int, segment_len: int) -> List[int]:
    """Split points of a segmented prefill: the ragged remainder goes
    FIRST (a fresh prefill takes any length; a remainder below 64 is
    merged into it), every later segment is exactly `segment_len`."""
    r = L % segment_len
    if r and r < 64 and L > segment_len:
        r += segment_len
    bounds = [0, r or min(L, segment_len)]
    while bounds[-1] < L:
        bounds.append(min(bounds[-1] + segment_len, L))
    return bounds


def _segment_logits(seq: str, model, tokenizer: CharLevelTokenizer,
                    segment_len: int, prepend_bos: bool):
    """Prefill one sequence in segments through a cache of its own;
    yields (ids of the segment (1, l), its logits (1, l, V))."""
    ids, _ = prepare_batch([seq], tokenizer, prepend_bos=prepend_bos)
    L = ids.shape[1]
    cache = model.initialize_inference_params(
        1, _aligned_cache_len(L, _cache_align(model.config)))
    bounds = _segment_bounds(L, segment_len)
    for s, e in zip(bounds[:-1], bounds[1:]):
        logits, cache = model(ids[:, s:e], inference_params_dict=cache,
                              donate_cache=True, resume=s > 0)
        yield ids[:, s:e], logits


def score_sequences_segmented(seqs: Sequence[str], model,
                              tokenizer: CharLevelTokenizer,
                              segment_len: int = 8192,
                              reduce_method: str = 'mean',
                              prepend_bos: bool = True) -> List[float]:
    """`score_sequences` for long sequences: each is prefilled in segments
    of `segment_len` (exact Hyena state carry, attention over the KV
    buffer), one sequence at a time, so peak memory is one segment's
    activations plus the KV buffers. Matches `score_sequences`."""
    reduce_func = _reduce(reduce_method)
    scores = []
    for seq in seqs:
        pieces = []
        carry = None            # the previous segment's last logits
        for seg, logits in _segment_logits(seq, model, tokenizer,
                                           segment_len, prepend_bos):
            # position t's logits score token t+1: within the segment
            # logits[:, :-1] pair with seg[:, 1:], and the segment's first
            # token is scored by the previous segment's last logits
            if carry is not None:
                pieces.append(logits_to_logprobs(carry, seg[:, :1],
                                                 trim_bos=False))
            pieces.append(logits_to_logprobs(logits, seg))
            carry = logits[:, -1:]
        logprobs = torch.cat(pieces, dim=1)[0].cpu().numpy()
        scores.append(float(reduce_func(logprobs[:len(seq)])))
    return scores


def positional_entropies_segmented(seqs: Sequence[str], model,
                                   tokenizer: CharLevelTokenizer,
                                   segment_len: int = 8192,
                                   prepend_bos: bool = True
                                   ) -> List[np.ndarray]:
    """`positional_entropies` for long sequences, prefilled in segments as
    `score_sequences_segmented` does; the entropy is reduced per segment,
    so the logits of the whole sequence are never held at once."""
    out = []
    for seq in seqs:
        pieces = []
        for _, logits in _segment_logits(seq, model, tokenizer,
                                         segment_len, prepend_bos):
            logp = torch.log_softmax(logits.float(), dim=-1)
            pieces.append(-torch.sum(torch.exp(logp) * logp, dim=-1))
        ent = torch.cat(pieces, dim=1)[0].cpu().numpy()
        # with BOS, position i's entropy describes the prediction OF
        # sequence character i (the last position predicts nothing scored)
        if prepend_bos:
            ent = ent[:-1]
        out.append(ent[:len(seq)])
    return out
