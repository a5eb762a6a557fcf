"""The port's generation and streaming-scoring calls take the JAX package's
parameters, by name and in its order, with its meaning, so the
reference's own call sites (scripts/generate.py,
scripts/generation_to_folding.py, semantic_design/semantic_design.py, all
of which pass `cached_generation=True`) run against the port. On the CPU
with a tiny float32 model.
"""

import inspect

import numpy as np
import pytest
import torch

from evo_tpu import generation as jax_generation
from evo_tpu import scoring as jax_scoring
from evo_tpu_torch import generation
from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.generation import Generator, generate
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import score_stream

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def evo():
    return Evo('evo-1-8k-base', 'cpu', random_init=True,
               config_overrides=cli_tiny_overrides())


def _params(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize('port,ref', [
    (Generator.generate, jax_generation.Generator.generate),
    (generate, jax_generation.generate),
    (score_stream, jax_scoring.score_stream),
])
def test_signatures_follow_the_jax_package(port, ref):
    assert _params(port) == _params(ref)


def _prompt_ids(evo, n=2, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([evo.tokenizer.tokenize(''.join(rng.choice(
        list('ACGT'), length))) for _ in range(n)])


def test_jax_keywords_leave_greedy_generation_unchanged(evo, capsys):
    ids = _prompt_ids(evo, n=1)
    g = Generator(evo.model, evo.tokenizer, top_k=1, temperature=0.0)
    want, want_scores, _ = g.generate(input_ids=ids, num_tokens=8)
    got, scores, _ = g.generate(
        input_ids=ids, num_tokens=8, cached_generation=True, device='cpu',
        rng=torch.Generator().manual_seed(7), verbose=True,
        print_generation=True, skip_special_tokens=True, stop_at_eos=True)
    assert torch.equal(got, want) and torch.equal(scores, want_scores)
    out = capsys.readouterr().out
    # print_generation under verbose at B == 1: the tokens, space-separated
    assert ' '.join(evo.tokenizer.detokenize([int(t)]) for t in got[0]) \
        in out


def test_rng_replaces_the_seed(evo):
    ids = _prompt_ids(evo)
    g = Generator(evo.model, evo.tokenizer, top_k=4, temperature=1.0)
    by_seed, _, _ = g.generate(input_ids=ids, num_tokens=10, seed=5)
    by_rng, _, _ = g.generate(input_ids=ids, num_tokens=10, seed=0,
                              rng=torch.Generator().manual_seed(5))
    assert torch.equal(by_rng, by_seed)


def test_stop_at_eos_only_prints(evo, monkeypatch, capsys):
    """Two EOS in a row print the reference's message; nothing is cut."""
    ids = _prompt_ids(evo, n=1)
    monkeypatch.setattr(generation, 'sample', lambda logits, **kw: torch.full(
        logits.shape[:1], evo.tokenizer.eos_id, dtype=torch.long))
    g = Generator(evo.model, evo.tokenizer)
    got, _, _ = g.generate(input_ids=ids, num_tokens=5, stop_at_eos=True)
    assert got.shape == (1, 5)
    assert 'Stopping generation at EOS' in capsys.readouterr().out
    g.generate(input_ids=ids, num_tokens=5)
    assert 'Stopping' not in capsys.readouterr().out
    # without verbose, print_generation prints nothing
    g.generate(input_ids=ids, num_tokens=3, print_generation=True)
    assert capsys.readouterr().out == ''


@pytest.mark.parametrize('keywords', [
    # scripts/generate.py:123-127
    dict(temperature=0.0, top_k=1, top_p=1.0, batched=True,
         prepend_bos=False, cached_generation=True, prefill_segment_len=None,
         verbose=0, seed=0),
    # scripts/generation_to_folding.py:72
    dict(temperature=0.0, top_k=1, top_p=1.0, cached_generation=True,
         seed=0, verbose=0),
    # semantic_design/semantic_design.py:120, and an unknown keyword
    dict(temperature=0.0, top_k=1, batched=True,
         force_prompt_threshold=None, cached_generation=True, verbose=0,
         device='cpu', not_a_reference_keyword=3),
])
def test_reference_call_sites_run(evo, keywords):
    prompts = ['ACGTACGTAC', 'TTGACCAGTA']
    want = generate(prompts, evo.model, evo.tokenizer, n_tokens=6,
                    verbose=0)
    got = generate(prompts, evo.model, evo.tokenizer, n_tokens=6,
                   **keywords)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_score_stream_prefetch_depth(evo):
    rng = np.random.default_rng(1)
    seqs = [''.join(rng.choice(list('ACGT'), n)) for n in (5, 40, 33, 7)]
    batches = [seqs[:2], seqs[2:]]
    inline = score_stream(batches, evo.model, evo.tokenizer,
                          prefetch_depth=0)
    ahead = score_stream(batches, evo.model, evo.tokenizer,
                         prefetch_depth=2)
    assert inline == ahead and len(inline) == 4
