"""The PyTorch port's resumed prefill against the JAX package, on the CPU in
float32 at tiny widths (inputs from numpy seeds): attention of a segment
over the KV buffer, the Hyena mixer continued from a carried state, prefill
in segments, segmented scoring, and generation prefilled in segments or
resumed from a returned cache.

On CPU tensors the port's wrappers take their plain versions; the JAX
side runs its Pallas buffer kernel in interpret mode, or its own chunked
online softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.ops.pallas_attention as jax_pallas_attention
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu import scoring as jax_scoring
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.layers import attention as jax_attn
from evo_tpu.layers import hyena as jax_hyena
from evo_tpu.layers.hyena import HyenaState as JaxHyenaState
from evo_tpu_torch.checkpoint import (cache_from_jax, cache_to_jax,
                                      params_from_state_dict)
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.generation import (Generator, _cache_kv_len, _grow_cache,
                                      generate)
from evo_tpu_torch.layers import attention, hyena
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.attention_buffer import (attention_buffer_plain,
                                                flash_attention_buffer)
from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
from evo_tpu_torch.scoring import (_aligned_cache_len, _segment_bounds,
                                   positional_entropies,
                                   positional_entropies_segmented,
                                   score_sequences,
                                   score_sequences_segmented)
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK = 16          # hyena_matmul_chunk of the models below


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _rand(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture
def interpret_buffer_kernel(monkeypatch):
    """The JAX package's buffer kernel in interpret mode wherever its
    layers call it (the TPU lowering does not run on the CPU)."""
    orig = jax_pallas_attention.flash_attention_buffer
    monkeypatch.setattr(
        jax_pallas_attention, 'flash_attention_buffer',
        lambda *a, **kw: orig(*a, interpret=True, **kw))


@pytest.fixture(scope='module')
def setup():
    """(port EvoModel, tokenizer, JAX params, JAX config) on one set of
    weights, with a Hyena chunk small enough for segments to cross it."""
    jcfg = jax_tiny_config(hyena_matmul_chunk=CHUNK)
    cfg = tiny_config(hyena_matmul_chunk=CHUNK)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    model = EvoModel(cfg, params_from_state_dict(sd, cfg, 'cpu'))
    return model, CharLevelTokenizer(512), params, jcfg


def _seqs(rng, *lengths):
    return [''.join(rng.choice(list('ACGT'), n)) for n in lengths]


# -- the buffer-attention op ---------------------------------------------------

@pytest.mark.parametrize('B,Lq,T,offset', [
    (1, 40, 256, 0),             # a fresh segment into a longer buffer
    (1, 40, 256, 131),           # resumed at an unaligned offset
    (1, 64, 256, 192),           # the segment fills the buffer to the brim
    (1, 1, 128, 77),             # one query row (decode)
    (2, 8, 256, (100, 240)),     # per-row offsets
])
def test_attention_buffer_plain_matches_jax_kernel(B, Lq, T, offset):
    rng = np.random.default_rng(Lq + T)
    H, Dh = 2, 128
    q_j, q_t = _rand(rng, B, Lq, H, Dh)
    kb, vb = (rng.standard_normal((B, T, H, Dh)).astype(np.float32)
              for _ in range(2))
    # the tail past the last query is finite garbage the mask must ignore
    for b in range(B):
        end = (offset if isinstance(offset, int) else offset[b]) + Lq
        kb[b, end:] *= 10
        vb[b, end:] *= 10
    if isinstance(offset, int):
        off_j = off_t = offset
    else:
        off_j = jnp.asarray(offset, jnp.int32)
        off_t = torch.tensor(offset, dtype=torch.int32)
    want = jax_pallas_attention.flash_attention_buffer(
        q_j, jnp.asarray(kb), jnp.asarray(vb), off_j, interpret=True)
    before = sum(_build.LAUNCHES.values())
    got = flash_attention_buffer(q_t, torch.from_numpy(kb),
                                 torch.from_numpy(vb), off_t)
    assert sum(_build.LAUNCHES.values()) == before      # CPU: plain version
    assert got.shape == (B, Lq, H, Dh) and got.is_contiguous()
    # float32 on both sides; the two sum their chunks in another order
    _close(got, want, rtol=2e-5, atol=2e-5)


def test_attention_buffer_plain_chunks_and_tail():
    """Several chunks, a ragged last one, and chunks past the last query
    skipped: equal to dense attention over the live prefix."""
    rng = np.random.default_rng(0)
    B, Lq, T, H, Dh, off = 2, 5, 700, 2, 16, 301
    q, kb, vb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, Lq, H, Dh), (B, T, H, Dh), (B, T, H, Dh)))
    kb[:, off + Lq:] = 1e30       # never visited
    got = attention_buffer_plain(q, kb, vb, off)
    s = torch.einsum('blhd,bthd->bhlt', q, kb[:, :off + Lq]) / Dh ** 0.5
    row = torch.arange(Lq)[:, None]
    col = torch.arange(off + Lq)[None, :]
    s = s.masked_fill(col > off + row, float('-inf'))
    want = torch.einsum('bhlt,bthd->blhd', torch.softmax(s, -1),
                        vb[:, :off + Lq])
    _close(got, want)


def test_attention_buffer_refuses_bad_arguments():
    q = torch.zeros(1, 4, 2, 16)
    buf = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match='do not fit'):
        flash_attention_buffer(q, buf, buf, 5)
    with pytest.raises(ValueError, match='buffers must be'):
        flash_attention_buffer(q, buf[:, :, :1], buf[:, :, :1], 0)
    with pytest.raises(ValueError, match='int32'):
        flash_attention_buffer(q, buf, buf, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match='both or neither'):
        flash_attention_buffer(q, buf, buf, 0, ks=torch.zeros(1, 2, 8))


def _attn_pair(rng, D, H):
    """One attention layer's weights for both packages."""
    Dh = D // H
    w = {'wqkv': rng.standard_normal((D, 3, H, Dh)) * 0.05,
         'bqkv': rng.standard_normal((3, H, Dh)) * 0.01,
         'wo': rng.standard_normal((H, Dh, D)) * 0.05,
         'bo': rng.standard_normal((D,)) * 0.01}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    cfg = tiny_config(hidden_size=D, num_filters=D, num_attention_heads=H)
    mod = attention.Attention(cfg, dtype=torch.float32, device='cpu')
    for k, v in w.items():
        getattr(mod, k).copy_(torch.from_numpy(v))
    jcfg = jax_tiny_config(hidden_size=D, num_filters=D,
                           num_attention_heads=H)
    return {k: jnp.asarray(v) for k, v in w.items()}, jcfg, mod, cfg


@pytest.mark.parametrize('use_pallas', [False, True])
def test_mha_full_attend_buffer_matches_jax(interpret_buffer_kernel,
                                            use_pallas):
    """Two segments through one KV buffer: the second attends the buffer.
    JAX takes its chunked online softmax, or its kernel (interpreted)."""
    rng = np.random.default_rng(1)
    B, T, D, H = 2, 128, 256, 2
    jp, jcfg, tp, cfg = _attn_pair(rng, D, H)
    kv_j = {n: jnp.zeros((B, T, H, D // H)) for n in 'kv'}
    kv_t = {n: torch.zeros(B, T, H, D // H) for n in 'kv'}
    offset = 0
    for L in (37, 50):
        x_j, x_t = _rand(rng, B, L, D)
        y_j, kv_j = jax_attn.mha_full(
            jp, jcfg, x_j, offset=offset, kv_buffers=kv_j,
            attend_buffer=offset > 0, use_pallas=use_pallas and offset > 0)
        y_t, kv_t = attention.mha_full(tp, cfg, x_t, kv_t, offset=offset,
                                       attend_buffer=offset > 0)
        _close(y_t, y_j, rtol=2e-5, atol=2e-5)
        _close(kv_t['k'], kv_j['k'])
        _close(kv_t['v'], kv_j['v'])
        offset += L
    with pytest.raises(ValueError, match='cannot take positions'):
        attention.mha_full(tp, cfg, x_t, kv_t, offset=T - 10,
                           attend_buffer=True)
    with pytest.raises(ValueError, match='needs the kv_buffers'):
        attention.mha_full(tp, cfg, x_t, attend_buffer=True)


# -- the Hyena mixer continued from a state -----------------------------------

@pytest.mark.parametrize('lengths', [
    (32, 48),            # aligned: both multiples of the chunk
    (21, 45, 7),         # ragged: L > chunk, L % chunk != 0, then L < chunk
    (5, 2, 1, 40),       # segments below the FIR width with a carried tail
])
def test_hyena_full_with_state_matches_jax(setup, lengths):
    model, _, params, jcfg = setup
    jp = jax_model.layer_blocks(params, jcfg)[0]['hyena']
    tp, cfg = model.module.blocks[0].hyena, model.config
    rng = np.random.default_rng(sum(lengths))
    x_j, x_t = _rand(rng, 2, sum(lengths), 64)
    whole, whole_st = hyena.hyena_full(tp, cfg, x_t, collect_state=True)
    st_j = st_t = None
    s = 0
    for L in lengths:
        y_j, st_j = jax_hyena.hyena_full(jp, jcfg, x_j[:, s:s + L],
                                         collect_state=True, state=st_j)
        y_t, st_t = hyena.hyena_full(tp, cfg, x_t[:, s:s + L],
                                     collect_state=True, state=st_t)
        _close(y_t, y_j)
        _close(y_t, whole[:, s:s + L])
        _close(st_t.fir, st_j.fir)
        _close(st_t.iir, st_j.iir)
        assert st_t.fir.shape == (2, 3, 64, 2)
        s += L
    _close(st_t.fir, whole_st.fir)
    _close(st_t.iir, whole_st.iir)


@pytest.mark.parametrize('L', [1, 2, 9])
def test_fir_gate_with_tail_is_the_split_of_a_longer_sequence(L):
    """The carried tail takes the place of the zeros before t=0: the
    outputs equal those of the whole sequence at the same positions."""
    rng = np.random.default_rng(L)
    z = torch.from_numpy(rng.standard_normal((2, 3, 8, 20 + L),
                                             ).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    x2, u = fir_gate_plain(z, w, b)
    x2_s, u_s = fir_gate(z[..., 20:], w, b, tail=z[..., 18:20])
    _close(x2_s, x2[..., 20:], rtol=0, atol=0)
    _close(u_s, u[..., 20:], rtol=0, atol=0)


# -- prefill in segments -------------------------------------------------------

@pytest.mark.parametrize('bounds', [(0, 40, 101), (0, 37, 38, 90, 101)])
def test_segmented_prefill_matches_jax_and_one_pass(setup, bounds):
    model, _, params, jcfg = setup
    ids = np.random.default_rng(2).integers(0, 512, (2, 101)).astype(
        np.int32)
    one_pass, full_cache = model(
        ids, inference_params_dict=model.initialize_inference_params(2, 128))
    cache = model.initialize_inference_params(2, 128)
    jcache = jax_model.init_cache(jcfg, 2, 128)
    for s, e in zip(bounds[:-1], bounds[1:]):
        want, jcache = jax_model.prefill(params, jcfg, jnp.asarray(ids[:, s:e]),
                                         jcache, resume=s > 0)
        # a donated length-1 segment takes the prefill, as in the reference
        got, cache = model(ids[:, s:e], inference_params_dict=cache,
                           donate_cache=e - s == 1, resume=s > 0)
        assert cache['offset'] == e == int(jcache['offset'])
        _close(got, want, **LOGIT_TOL)
        _close(got, one_pass[:, s:e], **LOGIT_TOL)
    for a, b in zip(cache['layers'], full_cache['layers']):
        for x, y in zip(*((a.values(), b.values()) if isinstance(a, dict)
                          else (a, b))):
            _close(x, y, **LOGIT_TOL)
    # resume=None is derived from the cache's offset: a filled cache
    # continues, and the next step follows on
    step, cache = model(ids[:, :1], inference_params_dict=cache)
    want, _ = jax_model.decode_step(params, jcfg, jnp.asarray(ids[:, 0]),
                                    jcache)
    _close(step[:, 0], want, **LOGIT_TOL)


def test_cache_bridge_round_trip_and_cross_resume(setup):
    """A cache made by either package resumes the other."""
    model, _, params, jcfg = setup
    cfg = model.config
    ids = np.random.default_rng(3).integers(0, 512, (1, 60)).astype(np.int32)
    _, jcache = jax_model.prefill(params, jcfg, jnp.asarray(ids[:, :33]),
                                  jax_model.init_cache(jcfg, 1, 128))
    as_numpy = jax.tree_util.tree_map(np.asarray, jcache)
    cache = cache_from_jax(as_numpy, cfg, 'cpu')
    assert cache['offset'] == 33 and len(cache['layers']) == cfg.num_layers
    back = cache_to_jax(cache, cfg)
    assert int(back['offset']) == 33
    for a, b in zip(back['layers'], as_numpy['layers']):
        for x, y in zip(*((a.values(), b.values()) if isinstance(a, dict)
                          else (a, b))):
            np.testing.assert_array_equal(x, y)
    want, _ = jax_model.prefill(params, jcfg, jnp.asarray(ids[:, 33:]),
                                jcache, resume=True)
    got, cache = model(ids[:, 33:], inference_params_dict=cache)
    _close(got, want, **LOGIT_TOL)
    # and back: the JAX package decodes from the port's cache
    back = cache_to_jax(cache, cfg)
    jback = {'offset': jnp.asarray(back['offset']), 'layers': [
        {k: jnp.asarray(v) for k, v in seg.items()} if isinstance(seg, dict)
        else JaxHyenaState(*(jnp.asarray(a) for a in seg))
        for seg in back['layers']]}
    tok = np.array([7], np.int32)
    want, _ = jax_model.decode_step(params, jcfg, jnp.asarray(tok), jback)
    got, _ = model(tok[:, None], inference_params_dict=cache)
    _close(got[:, 0], want, **LOGIT_TOL)


# -- segmented scoring -----------------------------------------------------------

@pytest.mark.parametrize('L', [1, 63, 64, 100, 128, 130, 8191, 8192, 8193,
                               12001, 131073])
@pytest.mark.parametrize('segment_len', [1, 64, 100, 4096, 8192])
def test_segment_bounds_equal_jax(L, segment_len):
    bounds = _segment_bounds(L, segment_len)
    assert bounds == jax_scoring._segment_bounds(L, segment_len)
    assert bounds[0] == 0 and bounds[-1] == L
    assert all(e - s == segment_len
               for s, e in zip(bounds[1:-1], bounds[2:]))


@pytest.mark.parametrize('segment_len', [16, 64, 1000])
@pytest.mark.parametrize('prepend_bos', [True, False])
def test_segmented_scores_and_entropies_match_monolithic(setup, segment_len,
                                                         prepend_bos):
    model, tok, _, _ = setup
    seqs = _seqs(np.random.default_rng(4), 150, 70, 16)
    # the segmented entry points take one sequence at a time, so each is
    # held against the monolithic call on that sequence alone (without a
    # BOS a padded batch also scores a sequence's first pad token)
    for reduce_method in ('mean', 'sum'):
        want = [score_sequences([s], model, tok, reduce_method,
                                prepend_bos=prepend_bos)[0] for s in seqs]
        got = score_sequences_segmented(seqs, model, tok, segment_len,
                                        reduce_method,
                                        prepend_bos=prepend_bos)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = positional_entropies_segmented(seqs, model, tok, segment_len,
                                         prepend_bos=prepend_bos)
    for g, s in zip(got, seqs):
        want = positional_entropies([s], model, tok,
                                    prepend_bos=prepend_bos)[0]
        assert len(g) == len(s)
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)


def test_segmented_scores_match_jax(setup):
    model, tok, params, jcfg = setup
    from evo_tpu.models import EvoModel as JaxEvoModel
    seqs = _seqs(np.random.default_rng(5), 90)
    want = jax_scoring.score_sequences_segmented(
        seqs, JaxEvoModel(jcfg, params), tok, segment_len=32)
    got = score_sequences_segmented(seqs, model, tok, segment_len=32)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match='reduce_method'):
        score_sequences_segmented(seqs, model, tok, reduce_method='max')


# -- generation ------------------------------------------------------------------

@pytest.mark.parametrize('segment_len', [32, 33, 99])
def test_generation_with_prefill_segments_is_token_exact(setup, segment_len):
    model, tok, _, _ = setup
    prompt = _seqs(np.random.default_rng(6), 100)[0]
    g = Generator(model, tok, top_k=1)
    want, want_scores, _ = g.generate(prompt, num_tokens=12)
    got, scores, cache = g.generate(prompt, num_tokens=12,
                                    prefill_segment_len=segment_len)
    assert torch.equal(got, want) and cache['offset'] == 111
    _close(scores, want_scores, **LOGIT_TOL)


def test_module_generate_passes_prefill_segment_len(setup):
    model, tok, _, _ = setup
    prompts = _seqs(np.random.default_rng(7), 40, 40)
    want = generate(prompts, model, tok, n_tokens=6, verbose=0)
    got = generate(prompts, model, tok, n_tokens=6, prefill_segment_len=16,
                   verbose=0)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def _snapshot(cache):
    return [{k: v.clone() for k, v in layer.items()}
            if isinstance(layer, dict) else tuple(t.clone() for t in layer)
            for layer in cache['layers']]


def _same(layers, snapshot):
    return all(
        torch.equal(x, y)
        for a, b in zip(layers, snapshot)
        for x, y in zip(*((a.values(), b.values()) if isinstance(a, dict)
                          else (a, b))))


@pytest.mark.parametrize('chunks', [(5, 7), (1, 1, 10), (4, 4, 4)])
def test_generation_resumed_in_chunks_is_token_exact(setup, chunks):
    """Each call feeds the previous call's last token and its cache; the
    caller's cache is left as it was (no donate_cache)."""
    model, tok, _, _ = setup
    prompt = _seqs(np.random.default_rng(8), 50)[0]
    g = Generator(model, tok, top_k=1)
    want, want_scores, _ = g.generate(prompt, num_tokens=sum(chunks))
    toks, scores, cache = g.generate(prompt, num_tokens=chunks[0])
    parts, score_parts = [toks], [scores]
    for n in chunks[1:]:
        offset, snapshot = cache['offset'], _snapshot(cache)
        # the resumed call re-emits nothing: it consumes the last token and
        # emits n new ones
        toks, scores, new_cache = g.generate(
            input_ids=parts[-1][:, -1:], num_tokens=n,
            inference_params_dict=cache)
        assert cache['offset'] == offset and _same(cache['layers'], snapshot)
        assert new_cache is not cache and new_cache['offset'] == offset + n
        parts.append(toks)
        score_parts.append(scores)
        cache = new_cache
    assert torch.equal(torch.cat(parts, dim=1), want)
    _close(torch.cat(score_parts, dim=1), want_scores, **LOGIT_TOL)


def test_resumed_generation_grows_fits_and_donates(setup):
    model, tok, _, _ = setup
    prompt = _seqs(np.random.default_rng(9), 100)[0]
    g = Generator(model, tok, top_k=1)
    want, _, _ = g.generate(prompt, num_tokens=80)
    toks, _, cache = g.generate(prompt, num_tokens=20)
    assert _cache_kv_len(cache) == _aligned_cache_len(119) == 128
    # too short for 30 more: regrown to the aligned target, tail zeros
    t2, _, grown = g.generate(input_ids=toks[:, -1:], num_tokens=30,
                              inference_params_dict=cache,
                              cache_growth_align=256)
    assert _cache_kv_len(cache) == 128 and _cache_kv_len(grown) == 256
    assert grown['offset'] == 149
    # positions end at 149 + 1 + 31 - 2 = 179: a donated cache that fits
    # is kept at its length and updated in place
    k_before = grown['layers'][1]['k']
    t3, _, kept = g.generate(input_ids=t2[:, -1:], num_tokens=31,
                             inference_params_dict=grown, donate_cache=True)
    assert kept['layers'][1]['k'] is k_before and kept['offset'] == 180
    assert torch.equal(torch.cat([toks, t2, t3], dim=1)[:, :80], want)


def test_fit_check_takes_the_minimal_sufficient_buffer(setup):
    """The last sampled token is never written, so a run from offset o with
    a prompt of p tokens and n new ones ends at position o + p + n - 2: a
    buffer of exactly o + p + n - 1 positions is kept as it is. (The JAX
    package asks for one more and would regrow it.)"""
    model, tok, _, _ = setup
    g = Generator(model, tok, top_k=1)
    cache = model.initialize_inference_params(1, 24)
    _, cache = model(np.zeros((1, 16), np.int32), inference_params_dict=cache)
    _, _, out = g.generate(input_ids=np.zeros((1, 1), np.int32),
                           num_tokens=8, inference_params_dict=cache,
                           donate_cache=True)
    assert _cache_kv_len(out) == 24 and out['offset'] == 24
    cache = model.initialize_inference_params(1, 23)
    _, cache = model(np.zeros((1, 16), np.int32), inference_params_dict=cache)
    _, _, out = g.generate(input_ids=np.zeros((1, 1), np.int32),
                           num_tokens=8, inference_params_dict=cache)
    assert _cache_kv_len(out) == _aligned_cache_len(24, 8192) == 128


def test_grow_cache_copies_or_consumes(setup):
    model, _, _, _ = setup
    cache = model.initialize_inference_params(2, 16)
    _, cache = model(np.ones((2, 9), np.int32), inference_params_dict=cache)
    snapshot = _snapshot(cache)
    grown = _grow_cache(cache, 40)
    assert _cache_kv_len(grown) == 40 and _cache_kv_len(cache) == 16
    assert _same(cache['layers'], snapshot)
    k = grown['layers'][1]['k']
    assert torch.equal(k[:, :16], cache['layers'][1]['k'])
    assert not k[:, 16:].any()                  # the new tail is zeros
    assert grown['layers'][0].iir is not cache['layers'][0].iir
    same = _grow_cache(cache, 10)               # fits: a plain deep copy
    assert _cache_kv_len(same) == 16 and _same(same['layers'], snapshot)
    assert same['layers'][1]['k'] is not cache['layers'][1]['k']
    iir = cache['layers'][0].iir
    donated = _grow_cache(cache, 40, donate=True)
    assert donated['layers'][0].iir is iir      # handed through
    assert _cache_kv_len(donated) == 40 and not cache['layers'][1]
