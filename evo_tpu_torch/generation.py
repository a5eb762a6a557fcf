"""Autoregressive generation (port of `evo_tpu/generation.py`).

A fresh prompt is prefilled in one pass, then decoded by a Python loop of
`decode_step` calls. As in the reference:

  * teacher forcing of long prompts: with `force_prompt_threshold` set and
    a longer prompt, the first `force_prompt_threshold` tokens are
    prefilled and the rest are fed step by step as forced tokens;
  * the score of a generation pairs step-i logits with the step-(i+1)
    token (`logits_to_logprobs` with trim_bos=True).

Not ported yet: resuming from a passed `inference_params_dict` and
`prefill_segment_len` (both need the resumed prefill).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from evo_tpu_torch import model as model_lib
from evo_tpu_torch.ops.sampling import sample
from evo_tpu_torch.scoring import (_aligned_cache_len, logits_to_logprobs,
                                   prepare_batch)
from evo_tpu_torch.tokenizer import CharLevelTokenizer

_RESUME_TODO = ('(ROADMAP.md, modules queue: resumed prefill with the '
                'flash_attention_buffer kernel)')


class Generator:
    """Reference-parity generator over an `EvoModel`."""

    def __init__(self, model, tokenizer: CharLevelTokenizer,
                 top_k: int = 50, top_p: float = 0.7,
                 temperature: float = 1.0):
        self.model = model
        self.tokenizer = tokenizer
        self.top_k = top_k
        self.top_p = top_p
        self.temperature = temperature

    def generate(self, input_string: Optional[str] = None, input_ids=None,
                 num_tokens: int = 32,
                 force_prompt_threshold: Optional[int] = None,
                 prefill_segment_len: Optional[int] = None,
                 seed: int = 0, max_seqlen: Optional[int] = None,
                 inference_params_dict=None, verbose: bool = False):
        """Returns (generation (B, num_tokens), scores (B, num_tokens, V)
        float32 logits of each emitted step, cache). The cache has not
        consumed the last sampled token."""
        if inference_params_dict is not None:
            raise NotImplementedError(
                'generation resumed from an inference_params_dict is not '
                'ported yet ' + _RESUME_TODO)
        if prefill_segment_len is not None:
            raise NotImplementedError(
                'prefill_segment_len is not ported yet ' + _RESUME_TODO)
        if num_tokens < 1:
            raise ValueError('num_tokens must be >= 1')
        if input_ids is None:
            input_ids = self.tokenizer.tokenize(input_string)[None]
        device = self.model.device
        x = torch.as_tensor(input_ids, device=device).long()
        if x.dim() == 1:
            x = x[None]
        if max_seqlen is not None:
            x = x[:, -max_seqlen:]
        B, prompt_length = x.shape
        if prompt_length == 0:
            raise ValueError('Empty prompt: generation needs at least one '
                             'prompt token')
        if force_prompt_threshold is not None:
            force_prompt_threshold = max(1, force_prompt_threshold)
        if (force_prompt_threshold is not None
                and prompt_length > force_prompt_threshold):
            prompt, forced = (x[:, :force_prompt_threshold],
                              x[:, force_prompt_threshold:])
        else:
            prompt, forced = x, x[:, :0]
        num_forced = forced.shape[1]
        total = num_forced + num_tokens
        cache = self.model.initialize_inference_params(
            B, _aligned_cache_len(prompt.shape[1] + total - 1))
        rng = torch.Generator(device=device).manual_seed(seed)

        module = self.model.module
        logits, cache = model_lib.prefill(module, prompt, cache)
        last = logits[:, -1]
        toks, steps = [], []
        for i in range(total):
            tok = forced[:, i] if i < num_forced else sample(
                last, top_k=self.top_k, top_p=self.top_p,
                temperature=self.temperature, generator=rng)
            toks.append(tok)
            steps.append(last)
            if i < total - 1:
                last, cache = model_lib.decode_step(module, tok, cache)
        generation = torch.stack(toks[num_forced:], dim=1)
        scores = torch.stack(steps[num_forced:], dim=1)
        if verbose and B == 1:
            print(f'Prompt: {input_string!r} -> '
                  f'{self.tokenizer.detokenize_batch(generation.cpu())}')
        return generation, scores, cache


def generate(prompt_seqs: List[str], model, tokenizer: CharLevelTokenizer,
             n_tokens: int = 100, temperature: float = 0.0, top_k: int = 1,
             top_p: float = 1.0, batched: bool = True,
             prepend_bos: bool = False,
             force_prompt_threshold: Optional[int] = None,
             prefill_segment_len: Optional[int] = None,
             verbose: int = 1, seed: int = 0
             ) -> Tuple[List[str], List[float]]:
    """Generate from a list of prompts. Equal-length prompts run as one
    batch; ragged prompts run one at a time, as in the reference."""
    if not prompt_seqs:
        return [], []
    g = Generator(model, tokenizer, top_k=top_k, top_p=top_p,
                  temperature=temperature)
    uniform = all(len(s) == len(prompt_seqs[0]) for s in prompt_seqs)
    if batched and uniform:
        batches = [prepare_batch(prompt_seqs, tokenizer,
                                 prepend_bos=prepend_bos)[0]]
    else:
        if verbose:
            if not uniform:
                sys.stderr.write('Note: Prompts are of different lengths.\n')
            sys.stderr.write('Note: Will not do batched generation.\n')
        batches = [prepare_batch([s], tokenizer, prepend_bos=prepend_bos)[0]
                   for s in prompt_seqs]
    seqs: List[str] = []
    scores: List[float] = []
    for bi, input_ids in enumerate(batches):
        output_ids, logits, _ = g.generate(
            input_ids=input_ids, num_tokens=n_tokens,
            force_prompt_threshold=force_prompt_threshold,
            prefill_segment_len=prefill_segment_len, seed=seed + bi,
            verbose=verbose > 1)
        seqs += tokenizer.detokenize_batch(output_ids.cpu().numpy())
        logprobs = logits_to_logprobs(logits, output_ids.cpu()).cpu().numpy()
        scores += [float(np.mean(row)) for row in logprobs]
    if verbose:
        for seq, score, prompt in zip(seqs, scores, prompt_seqs):
            print(f'Prompt: "{prompt}",\tOutput: "{seq}",\tScore: {score}')
    return seqs, scores
