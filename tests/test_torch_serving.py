"""The PyTorch port's continuous-batching server (`evo_tpu_torch/serving.py`)
and the per-row (B,) decode offsets under it, against the JAX package and
against the port's own B=1 `Generator`, on the CPU in float32 at tiny
widths (weights carried across by `export_state_dict` ->
`params_from_state_dict`, caches by `cache_from_jax`).

Limits. A decode step with per-row offsets against JAX `decode_step`: 1e-4
on logits, as for every other step of the port; written KV rows within
1e-5 (float32; the two packages' projections sum in another order), int8
codes within one level at a tie. Greedy tokens: exact, against the port's
`Generator` and against the JAX server. The sampling filter: the kept set
equal to the JAX package's static filters, row by row; a sampled row's
frequencies within 0.03 of the filtered softmax over 4,000 draws (the
binomial standard deviation is at most 0.008). Sampled tokens are compared
with the port's own runs only: the generators are not JAX's threefry.
"""

import json
import os
import subprocess
import sys
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.ops.pallas_attention as jax_pallas_attention
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.layers import rotary as jax_rotary
from evo_tpu.models import EvoModel as JaxEvoModel
from evo_tpu.ops import sampling as jax_sampling
from evo_tpu.serving import GenerationServer as JaxGenerationServer
from evo_tpu.serving import _sample_slots as jax_sample_slots
from evo_tpu_torch import GenerationServer, serve_requests
from evo_tpu_torch import model as model_lib
from evo_tpu_torch import serving
from evo_tpu_torch.checkpoint import (cache_from_jax, cache_to_jax,
                                      params_from_state_dict)
from evo_tpu_torch.cli import serve as serve_cli
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.generation import Generator
from evo_tpu_torch.layers import attention, rotary
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.ops.sampling import NEG_INF
from evo_tpu_torch.quant import quantize_params
from evo_tpu_torch.serving import ServerLoop
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def setup():
    """(port model, tokenizer, JAX params, JAX config) on one set of
    weights."""
    jcfg = jax_tiny_config(hyena_matmul_chunk=16)
    cfg = tiny_config(hyena_matmul_chunk=16)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    module = params_from_state_dict(jax_ckpt.export_state_dict(params, jcfg),
                                    cfg, 'cpu')
    return EvoModel(cfg, module), CharLevelTokenizer(512), params, jcfg


def _greedy(model, tok, prompt, n, segment=None):
    """The port's B=1 greedy generation, the oracle of every greedy run."""
    gen, _, _ = Generator(model, tok, top_k=1, temperature=0.0).generate(
        input_ids=np.asarray(tok.tokenize(prompt))[None], num_tokens=n,
        prefill_segment_len=segment)
    return gen[0].numpy()


def _server(model, tok, **kw):
    kw.setdefault('max_len', 64)
    return GenerationServer(model, tok, **kw)


# -- per-row offsets in the engine -------------------------------------------

def test_rotary_per_row_positions_match_jax():
    pos = np.array([[0, 1, 2], [17, 18, 19]], np.int32)
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 16)).astype(
        np.float32)
    cos, sin = rotary.rotary_cos_sin(torch.from_numpy(pos), 16)
    jcos, jsin = jax_rotary.rotary_cos_sin(jnp.asarray(pos), 16)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), 1e-6, 1e-6)
    got = rotary.apply_rotary(torch.from_numpy(x), cos, sin)
    want = jax_rotary.apply_rotary(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-6, 1e-6)
    # a row of (B, L) positions equals the shared (L,) path bit for bit
    c1, s1 = rotary.rotary_cos_sin(torch.from_numpy(pos[1]), 16)
    np.testing.assert_array_equal(
        got[1:].numpy(),
        rotary.apply_rotary(torch.from_numpy(x[1:]), c1, s1).numpy())


def _random_jax_cache(jcfg, B, T, offsets, seed):
    """A JAX decode cache of random finite values (codes in [-127, 127]
    and positive scales under the int8 cache) with per-row offsets."""
    rng = np.random.default_rng(seed)
    cache = jax_model.init_cache(jcfg, B, T)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape, np.int8))
        v = rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(np.abs(v) * 0.02 + 1e-3 if a.ndim == 3 else
                           0.3 * v).astype(a.dtype)

    layers = [{k: fill(a) for k, a in seg.items()} if isinstance(seg, dict)
              else type(seg)(*(fill(a) for a in seg))
              for seg in cache['layers']]
    return {'offset': jnp.asarray(offsets, jnp.int32), 'layers': layers}


@pytest.mark.parametrize('kv_quant', ['none', 'int8'])
def test_per_row_offset_decode_matches_jax(setup, monkeypatch, kv_quant):
    """Two decode steps at offsets (0, 17, T - 3) against JAX decode_step
    with the same (B,) offsets: logits, the written KV rows, everything
    else of the cache untouched. Under the int8 cache JAX takes its buffer
    kernel in interpret mode (its decode without the kernel is another
    algorithm, int8 x int8 dots, that the port does not have)."""
    model, _, params, _ = setup
    orig = jax_pallas_attention.flash_attention_buffer
    monkeypatch.setattr(jax_pallas_attention, 'flash_attention_buffer',
                        lambda *a, **kw: orig(*a, interpret=True, **kw))
    jcfg = jax_tiny_config(hyena_matmul_chunk=16, kv_quant=kv_quant,
                           use_pallas='always' if kv_quant == 'int8'
                           else 'never')
    cfg = model.config.replace(kv_quant=kv_quant)
    B, T = 3, 128
    offsets = np.array([0, 17, T - 3], np.int32)
    jcache = _random_jax_cache(jcfg, B, T, offsets, seed=1)
    cache = cache_from_jax(jcache, cfg, 'cpu')
    assert cache['offset'].dtype == torch.int32
    before = jax.tree_util.tree_map(np.copy, cache_to_jax(cache, cfg))
    np.testing.assert_array_equal(before['offset'], offsets)
    toks = np.random.default_rng(2).integers(0, 512, (2, B))
    for tok in toks:
        want, jcache = jax_model.decode_step(params, jcfg,
                                             jnp.asarray(tok, jnp.int32),
                                             jcache)
        got, cache = model_lib.decode_step(model.module,
                                           torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    after = cache_to_jax(cache, cfg)
    np.testing.assert_array_equal(after['offset'], offsets + 2)
    np.testing.assert_array_equal(np.asarray(jcache['offset']), offsets + 2)
    t_axis = 2 if kv_quant == 'int8' else 1
    written = np.zeros((B, T), bool)
    written[np.arange(B), offsets] = written[np.arange(B), offsets + 1] = True
    for si, (kind, _) in enumerate(cfg.layer_segments()):
        got_l, want_l, old_l = (c['layers'][si] for c in (after, jcache,
                                                          before))
        if kind != 'attn':
            for g, w in zip(got_l, want_l):
                np.testing.assert_allclose(g, np.asarray(w), 1e-5, 1e-5)
            continue
        for name in got_l:
            g = np.moveaxis(got_l[name], t_axis, 1)        # (B, T, ...)
            w = np.moveaxis(np.asarray(want_l[name]), t_axis, 1)
            old = np.moveaxis(old_l[name], t_axis, 1)
            np.testing.assert_array_equal(g[~written], old[~written])
            if g.dtype == np.int8:
                diff = np.abs(g[written].astype(np.int32)
                              - w[written].astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, name
            else:
                np.testing.assert_allclose(g[written], w[written], 1e-5,
                                           1e-5)
            assert not np.array_equal(g[written], old[written]), name


def test_uniform_vector_offset_matches_scalar(setup):
    """decode_step with a uniform (B,) offset tensor equals the int
    offset (the masked whole buffer against the sliced live prefix)."""
    model, tok, _, _ = setup
    ids = np.stack([tok.tokenize('ACGTAC'), tok.tokenize('TTGGCC')])
    cache_s = model.initialize_inference_params(2, 32)
    logits, cache_s = model(ids, inference_params_dict=cache_s)
    cache_v = dict(cache_s, offset=torch.full((2,), 6, dtype=torch.int32),
                   layers=[dict(l) if isinstance(l, dict) else l
                           for l in cache_s['layers']])
    for name in ('k', 'v'):
        cache_v['layers'][1][name] = cache_s['layers'][1][name].clone()
    t = logits[:, -1].argmax(-1)
    for _ in range(2):
        ls, cache_s = model_lib.decode_step(model.module, t, cache_s)
        lv, cache_v = model_lib.decode_step(model.module, t, cache_v)
        np.testing.assert_allclose(ls.numpy(), lv.numpy(), 1e-5, 1e-5)
        t = ls.argmax(-1)
    assert cache_s['offset'] == 8
    np.testing.assert_array_equal(cache_v['offset'].numpy(), [8, 8])


def test_facade_routes_per_row_offsets(setup):
    """EvoModel: a length-1 input with a (B,) offset tensor is a decode
    step (even when donated); a prefill into such a cache raises, and so
    does mha_full with a tensor offset."""
    model, _, _, _ = setup
    cache = model.initialize_inference_params(2, 16)
    cache['offset'] = torch.tensor([3, 5], dtype=torch.int32)
    logits, cache = model(np.array([[1], [2]]), inference_params_dict=cache,
                          donate_cache=True)
    assert logits.shape == (2, 1, 512)
    np.testing.assert_array_equal(cache['offset'].numpy(), [4, 6])
    with pytest.raises(ValueError, match='decode steps only'):
        model(np.ones((2, 3), np.int64), inference_params_dict=cache)
    blk = model.module.blocks[1]
    with pytest.raises(ValueError, match='int offset'):
        attention.mha_full(blk.attn, model.config, torch.zeros(2, 1, 64),
                           cache['layers'][1], offset=cache['offset'])


# -- per-slot sampling --------------------------------------------------------

def _logits(rng, B, V=512):
    x = rng.standard_normal((B, V)).astype(np.float32) * 3
    x[0, :3] = x[0].max() + 1.0        # a three-way tie at the top
    return x


@pytest.mark.parametrize('temperature', [0.7, 1.0, 1.5])
def test_filter_slots_kept_sets_match_jax(temperature):
    """Twelve rows in one call, one per (k, p) of k in {0, 1, 3, V} and p
    in {0.3, 0.9, 1.0}: each row's kept set equals the JAX package's
    static top_k_filter then top_p_filter for its own k and p."""
    V = 512
    combos = [(k, p) for k in (0, 1, 3, V) for p in (0.3, 0.9, 1.0)]
    x = _logits(np.random.default_rng(3), len(combos), V) / temperature
    got = serving._filter_slots(
        torch.from_numpy(x), torch.tensor([k for k, _ in combos]),
        torch.tensor([p for _, p in combos], dtype=torch.float32)).numpy()
    for row, (k, p) in enumerate(combos):
        want = np.asarray(jax_sampling.top_p_filter(
            jax_sampling.top_k_filter(jnp.asarray(x[row:row + 1]), k), p))[0]
        np.testing.assert_array_equal(got[row] > NEG_INF / 2,
                                      want > NEG_INF / 2, err_msg=(k, p))
        kept = got[row] > NEG_INF / 2
        np.testing.assert_array_equal(got[row][kept], x[row][kept])


def test_sample_slots_greedy_rows_and_logp_match_jax():
    """Greedy rows (temperature 0, whatever their k and p) take the
    argmax, the first on a tie, and their log-probs equal JAX
    _sample_slots' within 1e-6; every row's logp is the chosen token's
    under the unfiltered distribution."""
    rng = np.random.default_rng(4)
    x = _logits(rng, 6)
    temps = np.array([0.0, 1.0, 0.0, 0.8, 0.0, 1.2], np.float32)
    ks = np.array([0, 4, 1, 0, 3, 2], np.int32)
    ps = np.array([1.0, 0.9, 0.3, 1.0, 0.5, 1.0], np.float32)
    gens = [None if t <= 0 else torch.Generator().manual_seed(i)
            for i, t in enumerate(temps)]
    tok, logp = serving._sample_slots(torch.from_numpy(x),
                                      torch.from_numpy(ks),
                                      torch.from_numpy(ps),
                                      torch.from_numpy(temps), gens)
    jtok, jlogp = jax_sample_slots(
        jax.random.split(jax.random.PRNGKey(0), 6), jnp.asarray(x),
        jnp.asarray(ks), jnp.asarray(ps), jnp.asarray(temps))
    greedy = temps <= 0
    np.testing.assert_array_equal(tok.numpy()[greedy], x.argmax(-1)[greedy])
    assert tok[0] == 0                                  # the first of a tie
    np.testing.assert_array_equal(tok.numpy()[greedy],
                                  np.asarray(jtok)[greedy])
    np.testing.assert_allclose(logp.numpy()[greedy],
                               np.asarray(jlogp)[greedy], rtol=0, atol=1e-6)
    full = np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(
        logp.numpy(), full[np.arange(6), tok.numpy()], rtol=0, atol=1e-6)
    assert tok.dtype == torch.int64


def test_sample_slots_frequencies_follow_filtered_softmax():
    """4,000 seeded draws of a row under k = 4, p = 0.9, temperature 0.8,
    beside a greedy row that draws nothing: the sampled row's frequencies
    are the filtered, temperature-scaled softmax within 0.03."""
    x = np.array([[2.0, 1.6, 1.5, 0.9, 0.8, -1.0, 0.1, 1.2],
                  [0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    ks = torch.tensor([4, 0])
    ps = torch.tensor([0.9, 1.0])
    temps = torch.tensor([0.8, 0.0])
    gen = torch.Generator().manual_seed(5)
    counts = np.zeros(8)
    for _ in range(4000):
        tok, _ = serving._sample_slots(torch.from_numpy(x), ks, ps, temps,
                                       [gen, None])
        counts[int(tok[0])] += 1
        assert int(tok[1]) == 1
    filt = np.asarray(jax_sampling.top_p_filter(
        jax_sampling.top_k_filter(jnp.asarray(x[:1] / 0.8), 4), 0.9))[0]
    want = np.exp(filt - filt.max())
    want /= want.sum()
    assert counts[want == 0].sum() == 0
    np.testing.assert_allclose(counts / 4000, want, rtol=0, atol=0.03)


def test_stream_seed_mixes_both_seeds():
    seeds = {serving._stream_seed(s, r) for s in range(4) for r in range(4)}
    assert len(seeds) == 16
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert serving._stream_seed(-1, 7) == serving._stream_seed(2 ** 64 - 1, 7)


# -- the server, greedy -------------------------------------------------------

PROMPTS = ['ACGT', 'TTGGCCAATTGGA', 'CCCCCCC', 'ACGTACGTACGTACGTAC',
           'GATTACA', 'TTTACGGACT']
LENS = [7, 3, 11, 5, 6, 9]


def test_ragged_staggered_matches_generator_and_jax_server(setup):
    """Six ragged prompts through two slots, the last two submitted while
    the first ones decode: every output equals the port's B=1 Generator
    and the JAX server's on the same weights, token for token."""
    model, tok, params, jcfg = setup

    def drive(server):
        rids = [server.submit(prompt=p, num_tokens=n)
                for p, n in zip(PROMPTS[:4], LENS[:4])]
        server.step()
        server.step()
        rids += [server.submit(prompt=p, num_tokens=n)
                 for p, n in zip(PROMPTS[4:], LENS[4:])]
        results = server.run()
        return [results[r].token_ids for r in rids]

    got = drive(_server(model, tok, max_slots=2, steps_per_sync=4))
    want_jax = drive(JaxGenerationServer(JaxEvoModel(jcfg, params), tok,
                                         max_slots=2, max_len=64,
                                         steps_per_sync=4))
    for g, w, p, n in zip(got, want_jax, PROMPTS, LENS):
        np.testing.assert_array_equal(g, _greedy(model, tok, p, n))
        np.testing.assert_array_equal(g, np.asarray(w))


def test_serve_requests_uniform_prompts_match_generator(setup):
    model, tok, _, _ = setup
    prompts = ['ACGTACGTAC', 'TTGGCCAATT']
    results = serve_requests(model, tok, prompts, num_tokens=10,
                             max_slots=2, steps_per_sync=4)
    for prompt, res in zip(prompts, results):
        want = _greedy(model, tok, prompt, 10)
        np.testing.assert_array_equal(res.token_ids, want)
        assert res.sequence == tok.detokenize(want.tolist())
        assert res.logps.shape == (10,) and res.score == pytest.approx(
            float(np.mean(res.logps)))


def test_late_submission_joins_running_batch(setup):
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=2, steps_per_sync=2)
    r0 = server.submit(prompt='ACGTACGT', num_tokens=12)
    server.step()
    server.step()
    r1 = server.submit(prompt='TTGG', num_tokens=5)
    results = server.run()
    np.testing.assert_array_equal(results[r0].token_ids,
                                  _greedy(model, tok, 'ACGTACGT', 12))
    np.testing.assert_array_equal(results[r1].token_ids,
                                  _greedy(model, tok, 'TTGG', 5))


def test_progress_is_monotonic_and_host_visible(setup):
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=1, steps_per_sync=2)
    r0 = server.submit(prompt='ACGTACGT', num_tokens=9)
    r1 = server.submit(prompt='TTGG', num_tokens=5)
    assert server.progress(r0) == 0 and server.progress(r1) == 0
    assert server.progress(12345) == 0
    server.step()
    p0 = server.progress(r0)
    assert p0 >= 1 and server.progress(r1) == 0
    server.step()
    assert server.progress(r0) > p0
    server.run()
    assert server.progress(r0) == 9 and server.progress(r1) == 5
    assert server.tokens_so_far(r1) == list(server.result(r1).token_ids)


def test_stop_token_ends_request_early(setup):
    model, tok, _, _ = setup
    want = _greedy(model, tok, 'ACGTACGTAC', 8)
    stop = int(want[3])
    server = _server(model, tok, max_slots=1, steps_per_sync=4,
                     stop_token=stop)
    rid = server.submit(prompt='ACGTACGTAC', num_tokens=8)
    res = server.run()[rid]
    np.testing.assert_array_equal(
        res.token_ids, want[:np.where(want == stop)[0][0] + 1])


def test_cancel_queued_and_active(setup):
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=1, steps_per_sync=2)
    r0 = server.submit(prompt='ACGTACGT', num_tokens=12)
    r1 = server.submit(prompt='TTGG', num_tokens=5)
    server.step()
    assert server.cancel(r1)
    res1 = server.result(r1)
    assert res1.cancelled and len(res1.token_ids) == 0
    p0 = server.progress(r0)
    assert p0 >= 1 and server.cancel(r0)
    res0 = server.result(r0)
    assert res0.cancelled and len(res0.token_ids) == p0
    np.testing.assert_array_equal(
        res0.token_ids, _greedy(model, tok, 'ACGTACGT', 12)[:p0])
    assert not server.cancel(r0) and not server.cancel(98765)
    r2 = server.submit(prompt='GATTACA', num_tokens=6)   # reuses the slot
    np.testing.assert_array_equal(server.run()[r2].token_ids,
                                  _greedy(model, tok, 'GATTACA', 6))


def test_interleaved_chunked_prefill_matches(setup):
    """prompt_chunk with prefill_chunks_per_sync=1: decode chunks run
    between a long prompt's prefill chunks, and the outputs equal the
    Generator prefilling in segments of the same length."""
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=2, max_len=96, steps_per_sync=2,
                     prompt_chunk=4, prefill_chunks_per_sync=1)
    r0 = server.submit(prompt='ACGTACGT', num_tokens=14)
    server.step()
    long_prompt = 'GATTACA' * 4
    r1 = server.submit(prompt=long_prompt, num_tokens=5)
    before = len(server._requests[r0].tokens)
    server.step()
    server.step()
    assert server._fill is not None
    assert len(server._requests[r0].tokens) > before
    results = server.run()
    np.testing.assert_array_equal(results[r0].token_ids,
                                  _greedy(model, tok, 'ACGTACGT', 14, 4))
    np.testing.assert_array_equal(results[r1].token_ids,
                                  _greedy(model, tok, long_prompt, 5, 4))


def test_chunked_prompt_prefill_matches_generator_segments(setup):
    model, tok, _, _ = setup
    prompts = ['ACGTACGTACGTA', 'TTGG', 'GATTACAGATTACA', 'ACGTACGT']
    server = _server(model, tok, max_slots=2, steps_per_sync=4,
                     prompt_chunk=4)
    rids = [server.submit(prompt=p, num_tokens=6) for p in prompts]
    results = server.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(model, tok, p, 6, 4))


def test_batched_prefill_matches_generator(setup):
    model, tok, _, _ = setup
    prompts = ['ACGTACGTAC', 'TTGGCCAATT', 'GATTACAGAT', 'CCCCCCCCCC',
               'ACGT']
    lens = [8, 5, 9, 6, 7]
    server = _server(model, tok, max_slots=4, steps_per_sync=4,
                     prefill_batch=2)
    rids = [server.submit(prompt=p, num_tokens=n)
            for p, n in zip(prompts, lens)]
    results = server.run()
    assert 2 in server._prefill_caches
    for rid, p, n in zip(rids, prompts, lens):
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(model, tok, p, n))


def test_batched_prefill_ladder_sizes(setup):
    """Two same-length prompts under prefill_batch=4 group at 2, never a
    padded 4-row fill; a lone other length takes the B=1 path."""
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=4, steps_per_sync=4,
                     prefill_batch=4)
    prompts = ['ACGTACGT', 'TTGGCCAA', 'GATTACA']
    rids = [server.submit(prompt=p, num_tokens=6) for p in prompts]
    results = server.run()
    assert 4 not in server._prefill_caches and 2 in server._prefill_caches
    assert [server._group_size(n) for n in (1, 2, 3, 4, 7)] == [1, 2, 2, 4,
                                                               4]
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(model, tok, p, 6))


def test_batched_prefill_cancel_one_row(setup):
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=2, steps_per_sync=2,
                     prefill_batch=2, prompt_chunk=4,
                     prefill_chunks_per_sync=1)
    pa, pb = 'ACGTACGTACGT', 'TTGGCCAATTGG'
    ra = server.submit(prompt=pa, num_tokens=6)
    rb = server.submit(prompt=pb, num_tokens=6)
    server.step()
    assert server._fill is not None and len(server._fill['reqs']) == 2
    assert server.cancel(rb)
    results = server.run()
    assert results[rb].cancelled and len(results[rb].token_ids) == 0
    np.testing.assert_array_equal(results[ra].token_ids,
                                  _greedy(model, tok, pa, 6, 4))


class _PrefillSpy:
    """The model, counting the prefill calls made through it."""

    def __init__(self, model):
        self._model = model
        self.prefills = 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, ids, inference_params_dict=None, **kw):
        if inference_params_dict is not None and ids.shape[1] > 1:
            self.prefills += 1
        return self._model(ids, inference_params_dict=inference_params_dict,
                           **kw)


def test_prefix_cache_skips_the_prefill(setup):
    model, tok, _, _ = setup
    spy = _PrefillSpy(model)
    server = _server(spy, tok, max_slots=2, steps_per_sync=4, top_k=4,
                     seed=3)
    r = [server.submit(prompt='ACGTACGTAC', num_tokens=6),
         server.submit(prompt='ACGTACGTAC', num_tokens=6, temperature=1.0,
                       seed=77),
         server.submit(prompt='TTGGCCAATT', num_tokens=5),
         server.submit(prompt='TTGGCCAATT', num_tokens=5)]
    results = server.run()
    assert spy.prefills == 2, spy.prefills          # one per prompt
    np.testing.assert_array_equal(results[r[0]].token_ids,
                                  _greedy(model, tok, 'ACGTACGTAC', 6))
    for rid in r[2:]:
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(model, tok, 'TTGGCCAATT', 5))
    solo = _server(model, tok, max_slots=2, steps_per_sync=4, top_k=4,
                   seed=3)
    rid = solo.submit(prompt='ACGTACGTAC', num_tokens=6, temperature=1.0,
                      seed=77)
    np.testing.assert_array_equal(results[r[1]].token_ids,
                                  solo.run()[rid].token_ids)


def test_prefix_cache_survives_interleaved_prompts(setup):
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=2, steps_per_sync=2,
                     prompt_chunk=4)
    prompts = ['ACGTACGT', 'GATTACAGATT', 'ACGTACGT', 'GATTACAGATT',
               'GATTACAGATT']
    rids = [server.submit(prompt=p, num_tokens=4) for p in prompts]
    results = server.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(model, tok, p, 4, 4))


@pytest.mark.parametrize('mode', ['int8_weights', 'int8_kv'])
def test_quantized_modes_match_their_generator(setup, mode):
    """int8 weights, and the int8 KV cache (whose decode reads the buffer
    through kernel 5's plain version with per-row offsets): greedy outputs
    equal the port's Generator under the same mode."""
    model, tok, _, _ = setup
    if mode == 'int8_weights':
        qmodel = EvoModel(model.config.replace(weight_quant='int8'),
                          quantize_params(model.module, mode='int8'))
    else:
        qmodel = EvoModel(model.config.replace(kv_quant='int8'),
                          model.module)
    prompts = ['ACGTACGTAC', 'TTGG', 'GATTACAGATTACA']
    server = _server(qmodel, tok, max_slots=2, steps_per_sync=4,
                     prompt_chunk=8)
    if mode == 'int8_kv':
        assert server._cache_len == 128                 # the JAX rounding
        assert server._cache['layers'][1]['k'].dtype == torch.int8
    rids = [server.submit(prompt=p, num_tokens=6) for p in prompts]
    results = server.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(qmodel, tok, p, 6, 8))


# -- the server, sampled ------------------------------------------------------

def test_sampled_requests_deterministic_across_traffic_mixes(setup):
    """A sampled request's output depends on (server seed, request seed,
    prompt) only: not on its co-tenants, its arrival or its slot."""
    model, tok, _, _ = setup

    def alone():
        s = _server(model, tok, max_slots=2, top_k=4, steps_per_sync=4,
                    seed=11)
        rid = s.submit(prompt='ACGTACGTAC', num_tokens=8, temperature=1.0,
                       seed=123)
        return s.run()[rid].token_ids

    def crowded():
        s = _server(model, tok, max_slots=2, top_k=4, steps_per_sync=4,
                    seed=11)
        s.submit(prompt='TTGGCCAATT', num_tokens=11, temperature=0.9,
                 seed=5)
        rid = s.submit(prompt='ACGTACGTAC', num_tokens=8, temperature=1.0,
                       seed=123)
        s.submit(prompt='GATTACA', num_tokens=3, temperature=0.5, seed=9)
        return s.run()[rid].token_ids

    a = alone()
    np.testing.assert_array_equal(a, crowded())
    other = _server(model, tok, max_slots=2, top_k=4, steps_per_sync=4,
                    seed=12)
    rid = other.submit(prompt='ACGTACGTAC', num_tokens=8, temperature=1.0,
                       seed=123)
    assert not np.array_equal(a, other.run()[rid].token_ids)


def test_batched_prefill_sampled_matches_unbatched(setup):
    model, tok, _, _ = setup
    prompts = ['ACGTACGTAC', 'TTGGCCAATT', 'GATTACAGAT', 'CCAATTGGCC']

    def run(pb):
        server = _server(model, tok, max_slots=4, steps_per_sync=4,
                         prefill_batch=pb, seed=7)
        rids = [server.submit(prompt=p, num_tokens=9, temperature=0.9,
                              top_k=3, seed=13 + i)
                for i, p in enumerate(prompts)]
        res = server.run()
        return [res[r].token_ids for r in rids]

    for a, b in zip(run(0), run(4)):
        np.testing.assert_array_equal(a, b)


def test_per_request_top_k_top_p_and_scores(setup):
    """temperature 1 with top_k=1, or with a vanishing top_p, keeps only
    the argmax, so it equals greedy while a co-tenant samples; scores are
    finite mean log-probs."""
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=3, top_k=0, steps_per_sync=3,
                     seed=11)
    want = _greedy(model, tok, 'ACGTACGTAC', 7)
    r_k1 = server.submit(prompt='ACGTACGTAC', num_tokens=7, temperature=1.0,
                         top_k=1)
    r_p0 = server.submit(prompt='ACGTACGTAC', num_tokens=7, temperature=1.0,
                         top_p=1e-9)
    r_hot = server.submit(prompt='ACGTACGTAC', num_tokens=7,
                          temperature=1.0, top_k=4)
    results = server.run()
    np.testing.assert_array_equal(results[r_k1].token_ids, want)
    np.testing.assert_array_equal(results[r_p0].token_ids, want)
    assert len(results[r_hot].token_ids) == 7
    for res in results.values():
        assert np.isfinite(res.score) and res.score <= 0.0


# -- no host read in the decode chunk -----------------------------------------

def test_decode_chunk_reads_nothing_back(setup, monkeypatch):
    """One step() with no fill pending: inside the decode chunk no tensor
    is read by the host (`item`, `tolist`, `bool`, `int`, `float` raise),
    no Python number is assigned into a tensor (on the card that goes
    through a host scalar and `aten::_local_scalar_dense`), and the
    profiler sees no `aten::_local_scalar_dense` in the step."""
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=3, steps_per_sync=4, top_k=3)
    r0 = server.submit(prompt='ACGTACGT', num_tokens=30)
    r1 = server.submit(prompt='TTGGCA', num_tokens=30, temperature=1.0)
    server.step()
    assert server._fill is None and not server._queue
    real = serving._decode_chunk
    real_setitem = torch.Tensor.__setitem__

    def refuse(*_, **__):
        raise AssertionError('host read inside the decode chunk')

    def setitem(t, index, value):
        if isinstance(value, (bool, int, float)):
            raise AssertionError('a Python number assigned into a tensor '
                                 'inside the decode chunk')
        return real_setitem(t, index, value)

    def guarded(*a, **kw):
        with monkeypatch.context() as m:
            for name in ('item', 'tolist', '__bool__', '__int__',
                         '__float__', '__index__'):
                m.setattr(torch.Tensor, name, refuse)
            m.setattr(torch.Tensor, '__setitem__', setitem)
            return real(*a, **kw)

    monkeypatch.setattr(serving, '_decode_chunk', guarded)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        server.step()
    names = [e.name for e in prof.events()]
    assert 'aten::_local_scalar_dense' not in names
    assert server.progress(r0) == server.progress(r1) == 9


# -- threads, validation, devices ---------------------------------------------

def test_server_loop_submit_wait_and_stream(setup):
    model, tok, _, _ = setup
    loop = ServerLoop(_server(model, tok, max_slots=2, steps_per_sync=2))
    prompts = ['ACGTACGT', 'TTGG', 'GATTACA']
    out = {}

    def client(p):
        out[p] = loop.wait(loop.submit(prompt=p, num_tokens=6), timeout=120)

    threads = [threading.Thread(target=client, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    streamed = list(loop.stream(loop.submit(prompt='CCGGA', num_tokens=9)))
    for t in threads:
        t.join()
    assert loop.cancel(10 ** 6) is False
    loop.close()
    for p in prompts:
        np.testing.assert_array_equal(out[p].token_ids,
                                      _greedy(model, tok, p, 6))
    np.testing.assert_array_equal(streamed, _greedy(model, tok, 'CCGGA', 9))


def test_validation_errors(setup):
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=1, max_len=16)
    with pytest.raises(ValueError):
        server.submit(prompt='', num_tokens=4)
    with pytest.raises(ValueError):
        server.submit(prompt='ACGT', num_tokens=0)
    with pytest.raises(ValueError):
        server.submit(prompt='ACGTACGTACGT', num_tokens=8)   # > max_len
    with pytest.raises(ValueError):
        server.submit(num_tokens=4)
    with pytest.raises(ValueError):
        GenerationServer(model, None).submit(prompt='ACGT')
    with pytest.raises(ValueError):
        GenerationServer(model, tok, max_slots=0)


@pytest.mark.skipif(torch.cuda.is_available(), reason='needs a CPU-only host')
def test_server_on_cuda_without_a_card_raises(setup):
    model, tok, _, _ = setup
    fake = types.SimpleNamespace(config=model.config,
                                 device=torch.device('cuda'))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        GenerationServer(fake, tok)


def test_rows_past_their_end_stay_inside_the_cache(setup):
    """Requests that fill max_len exactly, with a chunk longer than their
    last steps: the offsets never leave the cache, and the outputs are
    still the Generator's."""
    model, tok, _, _ = setup
    server = _server(model, tok, max_slots=2, max_len=16, steps_per_sync=8)
    prompts = ['ACGTACGTAC', 'TTGGCCAATTG']
    rids = [server.submit(prompt=p, num_tokens=16 - len(p))
            for p in prompts]
    results = server.run()
    assert int(server._cache['offset'].max()) <= 15
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid].token_ids,
                                      _greedy(model, tok, p, 16 - len(p)))


# -- the command line ---------------------------------------------------------

TINY = ['--tiny', '--device', 'cpu', '--max-slots', '2', '--max-len', '64',
        '--steps-per-sync', '4']


def _cli_greedy(prompt, n):
    server = serve_cli.build_server(serve_cli.build_parser().parse_args(TINY))
    return _greedy(server.model, server.tokenizer, prompt, n)


def test_serve_cli_jsonl(tmp_path):
    reqs = tmp_path / 'reqs.jsonl'
    out = tmp_path / 'out.jsonl'
    reqs.write_text(json.dumps({'id': 'a', 'prompt': 'ACGTACGT',
                                'num_tokens': 6}) + '\n\n'
                    + json.dumps({'prompt': 'TTGG'}) + '\n')
    serve_cli.main(TINY + ['--n-tokens', '5', '--requests-jsonl', str(reqs),
                           '--output-jsonl', str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x['id'] for x in lines] == ['a', 1]
    assert [x['num_tokens'] for x in lines] == [6, 5]
    tok = CharLevelTokenizer(512)
    assert lines[0]['sequence'] == tok.detokenize(
        _cli_greedy('ACGTACGT', 6).tolist())
    assert all(np.isfinite(x['score']) for x in lines)


def test_serve_cli_http():
    args = serve_cli.build_parser().parse_args(
        TINY + ['--http', '0', '--n-tokens', '5'])
    server = serve_cli.build_server(args)
    want = _greedy(server.model, server.tokenizer, 'ACGTACGT', 6)
    seq = server.tokenizer.detokenize(want.tolist())
    httpd, loop = serve_cli.make_http_server(args, server)
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({'prompt': 'ACGTACGT', 'num_tokens': 6}).encode()
        resp = json.loads(urllib.request.urlopen(
            url + '/generate', data=body, timeout=120).read())
        assert resp['sequence'] == seq and resp['num_tokens'] == 6
        health = json.loads(urllib.request.urlopen(url + '/health',
                                                   timeout=30).read())
        assert health == {'ok': True, 'pending': 0}
        lines = [json.loads(x) for x in urllib.request.urlopen(
            url + '/stream', data=body, timeout=120).read().splitlines()]
        np.testing.assert_array_equal(
            [x['token'] for x in lines if 'token' in x], want)
        assert lines[-1]['sequence'] == seq
        resp = json.loads(urllib.request.urlopen(
            url + '/cancel', data=json.dumps({'id': 99999}).encode(),
            timeout=30).read())
        assert resp == {'id': 99999, 'cancelled': False}
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()


def test_serving_imports_leave_jax_unloaded():
    """The server and its command line import neither JAX nor the JAX
    package (the hygiene test's subprocess check does not list them)."""
    code = ('import sys, evo_tpu_torch.serving, evo_tpu_torch.cli.serve; '
            'assert "jax" not in sys.modules and "evo_tpu" not in '
            'sys.modules, sorted(sys.modules)')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def test_serve_cli_refuses_parallelism():
    """--dp / --tp / --cp above 1 in one process raise and say how to
    launch the ranks (serving under a mesh: tests/
    test_torch_mesh_serving.py)."""
    for flag in ('--dp', '--tp', '--cp'):
        with pytest.raises(ValueError, match='one process a rank: launch '
                           'with torchrun'):
            serve_cli.main(TINY + [flag, '2'])
    args = serve_cli.build_parser().parse_args([])
    assert (args.device, args.max_slots, args.max_len, args.steps_per_sync,
            args.prompt_chunk, args.prefill_batch) == ('cuda', 8, 8192, 32,
                                                       128, 8)
