"""Autoregressive generation (port of `evo_tpu/generation.py`).

A prompt is prefilled (in one pass, or in segments with
`prefill_segment_len`), then decoded by a Python loop of `decode_step`
calls. As in the reference:

  * the cache (`inference_params_dict`) can be passed in and is returned,
    so sampling resumes across calls. The returned cache has NOT consumed
    the last sampled token: a resuming caller feeds it as the new input;
  * teacher forcing of long prompts: with `force_prompt_threshold` set and
    a longer prompt, the first `force_prompt_threshold` tokens are
    prefilled and the rest are fed step by step as forced tokens;
  * the score of a generation pairs step-i logits with the step-(i+1)
    token (`logits_to_logprobs` with trim_bos=True).

The engine updates a cache in place, so a resumed call clones the passed
cache first and leaves the caller's as it was, unless `donate_cache`.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from evo_tpu_torch import model as model_lib
from evo_tpu_torch.layers.hyena import HyenaState
from evo_tpu_torch.ops.sampling import sample
from evo_tpu_torch.runtime import device_memory_report
from evo_tpu_torch.scoring import (_aligned_cache_len, _cache_align,
                                   logits_to_logprobs, prepare_batch)
from evo_tpu_torch.tokenizer import CharLevelTokenizer


def _cache_kv_len(cache) -> Optional[int]:
    """Length of the attention KV buffers, or None for a cache without
    attention layers (time is axis 1 of a (B, T, H, Dh) buffer, axis 2 of
    a head-major int8 one)."""
    for layer in cache['layers']:
        if isinstance(layer, dict):
            return layer['k'].shape[2 if 'ks' in layer else 1]
    return None


def _grow_cache(cache, needed_len: int, donate: bool = False):
    """A cache whose KV buffers hold at least `needed_len` positions, the
    new tail zeros. Only the KV buffers depend on the length; the Hyena
    state does not.

    donate=False returns a deep copy (the engine writes into a cache in
    place, and the caller's stays valid for reuse). donate=True consumes
    the caller's cache: buffers that fit are handed through, and a buffer
    that grows is dropped as soon as its longer copy exists, so at most
    one buffer is held twice."""
    current = _cache_kv_len(cache)
    pad = 0 if current is None else max(0, needed_len - current)

    def carry(t: torch.Tensor, t_axis: Optional[int] = None):
        if pad and t_axis is not None:
            shape = list(t.shape)
            shape[t_axis] += pad
            out = torch.zeros(shape, dtype=t.dtype, device=t.device)
            out.narrow(t_axis, 0, current).copy_(t)
            return out
        return t if donate else t.clone()

    layers = []
    for layer in cache['layers']:
        if isinstance(layer, dict):
            t_axis = 2 if 'ks' in layer else 1
            # a donated buffer leaves the caller's dict before its longer
            # copy is made, so no other reference keeps it alive after
            layers.append({
                name: carry(layer.pop(name) if donate else layer[name],
                            t_axis) for name in list(layer)})
        else:
            layers.append(HyenaState(*(carry(t) for t in layer)))
    return {'offset': cache['offset'], 'layers': layers}


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
                 num_tokens: int = 32, cached_generation: bool = True,
                 force_prompt_threshold: Optional[int] = None,
                 prefill_segment_len: Optional[int] = None,
                 seed: int = 0, rng: Optional[torch.Generator] = None,
                 verbose: bool = False, max_seqlen: Optional[int] = None,
                 inference_params_dict=None, cache_growth_align: int = 8192,
                 donate_cache: bool = False, device: Optional[str] = None,
                 print_generation: bool = False,
                 skip_special_tokens: bool = False,
                 stop_at_eos: bool = False):
        """Returns (generation (B, num_tokens), scores (B, num_tokens, V)
        float32 logits of each emitted step, cache). The cache has not
        consumed the last sampled token.

        The parameters are the JAX package's, in its order.
        `cached_generation`, `skip_special_tokens` and `device` are accepted
        and unused (decode is always cached; the model's device is used).
        `rng`, a `torch.Generator` on the model's device, replaces the one
        made from `seed`. `verbose` prints the device memory before and
        after generation (`runtime.device_memory_report`). `stop_at_eos` only prints `Stopping generation at
        EOS` where two EOS tokens follow each other in the first row; the
        generation is never cut. `print_generation` prints the tokens under
        `verbose` at B == 1.

        inference_params_dict: a cache returned by an earlier call; the
        input continues its sequence. Its KV buffers are grown when they
        are too short, to a length rounded up to `cache_growth_align` so
        that a generation resumed in many chunks regrows rarely; buffers
        that already fit are kept at their length.

        donate_cache: consume the passed cache (update it in place, and
        free each old KV buffer during regrowth) where the default clones
        it and leaves the caller's valid.

        prefill_segment_len: prefill a longer prompt in segments of this
        many tokens through the resumed prefill, for activation memory of
        one segment."""
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

        align = _cache_align(self.model.config)
        resume = inference_params_dict is not None
        if resume:
            # The last sampled token is never written, so the run's
            # positions end at offset + prompt + total - 2: a buffer of
            # `needed` positions holds them all.
            needed = inference_params_dict['offset'] + prompt.shape[1] \
                + total - 1
            current = _cache_kv_len(inference_params_dict)
            if current is not None and current < needed:
                needed = _aligned_cache_len(
                    needed, max(align, int(cache_growth_align)))
            cache = _grow_cache(inference_params_dict, needed,
                                donate=donate_cache)
        else:
            cache = self.model.initialize_inference_params(
                B, _aligned_cache_len(prompt.shape[1] + total - 1, align))

        if (prefill_segment_len is not None
                and prompt.shape[1] > prefill_segment_len):
            # the prompt's head in whole segments through the resumed
            # prefill; its tail (at least one token) goes below
            head_len = ((prompt.shape[1] - 1) // prefill_segment_len) \
                * prefill_segment_len
            for s in range(0, head_len, prefill_segment_len):
                _, cache = self.model(
                    prompt[:, s:s + prefill_segment_len],
                    inference_params_dict=cache, donate_cache=True,
                    resume=resume or s > 0)
            prompt = prompt[:, head_len:]
            resume = True

        if rng is None:
            rng = torch.Generator(device=device).manual_seed(seed)
        if verbose:
            # the reference prints device memory under verbose
            print(f'Memory before generation: {device_memory_report()}',
                  flush=True)
        module = self.model.module
        logits, cache = model_lib.prefill(module, prompt, cache,
                                          resume=resume)
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
        if verbose:
            print(f'Memory after generation: {device_memory_report()}',
                  flush=True)
        if stop_at_eos or (print_generation and verbose and B == 1):
            gen = generation[0].cpu().numpy()
            eos = self.tokenizer.eos_id
            if stop_at_eos and ((gen[:-1] == eos) & (gen[1:] == eos)).any():
                print('Stopping generation at EOS')
            if print_generation and verbose and B == 1:
                print(' '.join(self.tokenizer.detokenize([int(t)])
                               for t in gen), flush=True)
        if verbose and B == 1:
            print(f'Prompt: {input_string!r} -> '
                  f'{self.tokenizer.detokenize_batch(generation.cpu())}')
        return generation, scores, cache


def generate(prompt_seqs: List[str], model, tokenizer: CharLevelTokenizer,
             n_tokens: int = 100, temperature: float = 0.0, top_k: int = 1,
             top_p: float = 1.0, batched: bool = True,
             prepend_bos: bool = False, cached_generation: bool = True,
             force_prompt_threshold: Optional[int] = None,
             prefill_segment_len: Optional[int] = None,
             verbose: int = 1, seed: int = 0, device: Optional[str] = None,
             **kwargs) -> Tuple[List[str], List[float]]:
    """Generate from a list of prompts. Equal-length prompts run as one
    batch; ragged prompts run one at a time, as in the reference. The
    parameters are the JAX package's, in its order: `device` and any other
    keyword are accepted and unused, `cached_generation` is passed on."""
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
            cached_generation=cached_generation,
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
