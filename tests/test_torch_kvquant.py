"""The PyTorch port's int8 KV cache (`kv_quant='int8'`) against the JAX
package, on the CPU in float32 at tiny widths (inputs from numpy seeds).

The cache holds head-major int8 codes with one float32 scale per
(position, head). On the same inputs the codes and scales equal the JAX
package's exactly; what reads them back (a resumed segment, every decode step) goes
through the buffer-attention op, whose plain version stands in for the
kernel on CPU tensors. The JAX side runs its int8 Pallas kernel in
interpret mode, or its chunked online softmax.

Limits. Against the JAX package on the same codes: 1e-4 on logits, as for
the unquantised cache. Between an int8 and an unquantised cache: 127
levels per (position, head) give a relative error up to 1/254 per element
of k and v; on these models' logits (|logit| below 1) that stays under
1e-2, which a wrong scale or layout (errors of the logits' own size)
fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.ops.pallas_attention as jax_pallas_attention
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.layers import attention as jax_attn
from evo_tpu_torch import model as model_lib
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.generation import Generator, _cache_kv_len, _grow_cache
from evo_tpu_torch.layers import attention
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.ops.attention_buffer import (attention_buffer_plain,
                                                flash_attention_buffer)
from evo_tpu_torch.scoring import (_aligned_cache_len, _cache_align,
                                   score_sequences,
                                   score_sequences_segmented)
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
QUANT_TOL = dict(rtol=0, atol=1e-2)


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
    """(int8-cache port model, unquantised port model on the same module,
    tokenizer, JAX params, JAX int8 config)."""
    jcfg = jax_tiny_config(hyena_matmul_chunk=16, kv_quant='int8')
    cfg = tiny_config(hyena_matmul_chunk=16, kv_quant='int8')
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    module = params_from_state_dict(sd, cfg, 'cpu')
    return (EvoModel(cfg, module),
            EvoModel(cfg.replace(kv_quant='none'), module),
            CharLevelTokenizer(512), params, jcfg)


def _head_major(x):
    """(B, L, H, ...) numpy -> torch (B, H, L, ...)."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


# -- quantisation ----------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kv_quantize_codes_equal_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # the scale's floor
    x[0, 1, 1] = np.arange(16) - 7.5               # ties: half to even
    x_j = jnp.asarray(x).astype(getattr(jnp, dtype))
    x_t = torch.from_numpy(x).to(getattr(torch, dtype))
    q_j, s_j = jax_attn.kv_quantize(x_j)
    q_t, s_t = attention.kv_quantize(x_t)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert int(q_t.abs().max()) == 127
    assert s_t[0, 0, 0].numpy() == np.float32(1e-12)


def test_init_cache_int8_layout_equals_jax(setup):
    model, _, _, _, jcfg = setup
    cache = model.initialize_inference_params(2, 24)
    jcache = jax_model.init_cache(jcfg, 2, 24)
    layer, jlayer = cache['layers'][1], jcache['layers'][1]
    assert set(layer) == set(jlayer) == {'k', 'v', 'ks', 'vs'}
    for name in layer:
        assert tuple(layer[name].shape) == jlayer[name].shape
        assert str(layer[name].dtype).split('.')[1] == str(jlayer[name].dtype)
        assert not layer[name].any()
    assert _cache_kv_len(cache) == 24
    assert _cache_align(model.config) == 4096
    assert _cache_align(model.config.replace(kv_quant='none')) == 1024
    assert _aligned_cache_len(5000, 4096) == 8192
    with pytest.raises(ValueError, match='kv_quant'):
        tiny_config(kv_quant='int4')


# -- the buffer-attention op over int8 buffers -----------------------------------

def _quantized_buffers(rng, B, T, H, Dh):
    """Random K/V buffers quantised by the JAX package, in both packages'
    head-major layout: (jax k, v, ks, vs), (torch k, v, ks, vs)."""
    out_j, out_t = [], []
    for _ in range(2):
        q, s = jax_attn.kv_quantize(
            jnp.asarray(rng.standard_normal((B, T, H, Dh)), jnp.float32))
        out_j += [jnp.swapaxes(q, 1, 2), jnp.swapaxes(s, 1, 2)]
        out_t += [_head_major(np.asarray(q)), _head_major(np.asarray(s))]
    return ((out_j[0], out_j[2], out_j[1], out_j[3]),
            (out_t[0], out_t[2], out_t[1], out_t[3]))


@pytest.mark.parametrize('B,Lq,T,offset', [
    (1, 40, 256, 131),           # a resumed segment
    (1, 1, 128, 77),             # one query row (the decode step)
    (2, 8, 256, (100, 240)),     # per-row offsets
])
def test_attention_buffer_plain_int8_matches_jax_kernel(B, Lq, T, offset):
    rng = np.random.default_rng(Lq + T)
    H, Dh = 2, 128
    q_j, q_t = _rand(rng, B, Lq, H, Dh)
    bufs_j, bufs_t = _quantized_buffers(rng, B, T, H, Dh)
    if isinstance(offset, int):
        off_j = off_t = offset
    else:
        off_j = jnp.asarray(offset, jnp.int32)
        off_t = torch.tensor(offset, dtype=torch.int32)
    want = jax_pallas_attention.flash_attention_buffer(
        q_j, bufs_j[0], bufs_j[1], off_j, bufs_j[2], bufs_j[3],
        interpret=True)
    got = flash_attention_buffer(q_t, bufs_t[0], bufs_t[1], off_t,
                                 bufs_t[2], bufs_t[3])
    assert got.shape == (B, Lq, H, Dh) and got.dtype == torch.float32
    _close(got, want, rtol=2e-5, atol=2e-5)
    # the same as attending the dequantised values as a plain buffer
    k, v = ((c.float() * s[..., None]).transpose(1, 2)
            for c, s in ((bufs_t[0], bufs_t[2]), (bufs_t[1], bufs_t[3])))
    _close(got, attention_buffer_plain(q_t, k, v, off_t))


def test_attention_buffer_int8_refuses_bad_scales():
    q = torch.zeros(1, 4, 2, 16)
    buf = torch.zeros(1, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match='scales must be'):
        flash_attention_buffer(q, buf, buf, 0, torch.zeros(1, 8, 2),
                               torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match='buffers must be'):
        flash_attention_buffer(q, buf[..., :8], buf[..., :8], 0,
                               torch.zeros(1, 2, 8), torch.zeros(1, 2, 8))


# -- the attention layer ---------------------------------------------------------

def _attn_pair(rng, D, H):
    """One attention layer's weights for both packages, int8 KV cache."""
    Dh = D // H
    w = {'wqkv': rng.standard_normal((D, 3, H, Dh)) * 0.05,
         'bqkv': rng.standard_normal((3, H, Dh)) * 0.01,
         'wo': rng.standard_normal((H, Dh, D)) * 0.05,
         'bo': rng.standard_normal((D,)) * 0.01}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    cfg = tiny_config(hidden_size=D, num_filters=D, num_attention_heads=H,
                      kv_quant='int8')
    mod = attention.Attention(cfg, dtype=torch.float32, device='cpu')
    for k, v in w.items():
        getattr(mod, k).copy_(torch.from_numpy(v))
    jcfg = jax_tiny_config(hidden_size=D, num_filters=D,
                           num_attention_heads=H, kv_quant='int8')
    return {k: jnp.asarray(v) for k, v in w.items()}, jcfg, mod, cfg


def _caches_agree(kv_t, kv_j):
    """k and v reach the two packages' quantisers a few ulps apart (their
    projections sum in another order), so a scale may differ in its last
    bits and a code that sat on a tie by one level."""
    for name in ('ks', 'vs'):
        _close(kv_t[name], kv_j[name], rtol=1e-6, atol=0)
    for name in ('k', 'v'):
        diff = np.abs(kv_t[name].numpy().astype(np.int32)
                      - np.asarray(kv_j[name]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name


def _empty_int8_caches(B, H, T, Dh):
    shapes = {'k': ((B, H, T, Dh), 'int8'), 'v': ((B, H, T, Dh), 'int8'),
              'ks': ((B, H, T), 'float32'), 'vs': ((B, H, T), 'float32')}
    return ({n: jnp.zeros(s, getattr(jnp, d)) for n, (s, d) in shapes.items()},
            {n: torch.zeros(s, dtype=getattr(torch, d))
             for n, (s, d) in shapes.items()})


@pytest.mark.parametrize('use_pallas', [False, True])
def test_mha_full_and_step_int8_match_jax(interpret_buffer_kernel,
                                          use_pallas):
    """A fresh segment (attends its own unquantised k, v), a resumed one
    (attends the int8 buffer) and two decode steps through the int8 kernel.
    JAX takes its kernel (interpreted) where `use_pallas`; its decode step
    without the kernel is another algorithm (int8 x int8 dots) that the
    port does not have, so the steps are held against the kernel only."""
    rng = np.random.default_rng(1)
    B, T, D, H = 2, 128, 256, 2
    jp, jcfg, tp, cfg = _attn_pair(rng, D, H)
    kv_j, kv_t = _empty_int8_caches(B, H, T, D // H)
    offset = 0
    for L in (37, 50):
        x_j, x_t = _rand(rng, B, L, D)
        y_j, kv_j = jax_attn.mha_full(
            jp, jcfg, x_j, offset=offset, kv_buffers=kv_j,
            attend_buffer=offset > 0, use_pallas=use_pallas and offset > 0)
        y_t, kv_t = attention.mha_full(tp, cfg, x_t, kv_t, offset=offset,
                                       attend_buffer=offset > 0)
        _close(y_t, y_j, rtol=2e-5, atol=2e-5)
        if offset == 0:
            plain, _ = attention.mha_full(tp, cfg, x_t)
            _close(y_t, plain, rtol=0, atol=0)    # fresh: unquantised k, v
        _caches_agree(kv_t, kv_j)
        offset += L
    for _ in range(2):
        x_j, x_t = _rand(rng, B, 1, D)
        y_j, kv_j = jax_attn.mha_step(jp, jcfg, x_j, kv_j,
                                      jnp.int32(offset), use_pallas=True)
        y_t, kv_t = attention.mha_step(tp, cfg, x_t, kv_t, offset)
        _close(y_t, y_j, rtol=2e-5, atol=2e-5)
        _caches_agree(kv_t, kv_j)
        offset += 1


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize('bounds', [(0, 40, 101), (0, 37, 90, 101)])
def test_segmented_prefill_int8_matches_jax_and_one_pass(setup, bounds):
    model, plain_model, _, params, jcfg = setup
    ids = np.random.default_rng(2).integers(0, 512, (2, 101)).astype(
        np.int32)
    one_pass, _ = model(
        ids, inference_params_dict=model.initialize_inference_params(2, 128))
    unquantised, _ = plain_model(
        ids,
        inference_params_dict=plain_model.initialize_inference_params(2, 128))
    # a fresh prefill attends its own unquantised k and v
    _close(one_pass, unquantised, rtol=0, atol=0)
    cache = model.initialize_inference_params(2, 128)
    jcache = jax_model.init_cache(jcfg, 2, 128)
    for s, e in zip(bounds[:-1], bounds[1:]):
        want, jcache = jax_model.prefill(params, jcfg,
                                         jnp.asarray(ids[:, s:e]), jcache,
                                         resume=s > 0)
        got, cache = model(ids[:, s:e], inference_params_dict=cache,
                           resume=s > 0)
        _close(got, want, **LOGIT_TOL)
        _close(got, one_pass[:, s:e], **QUANT_TOL)
    assert float((got - one_pass[:, s:e]).abs().max()) > 0   # it did quantise


def test_decode_int8_cache_close_to_unquantised(setup):
    model, plain_model, _, _, _ = setup
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, (2, 40))
    steps = rng.integers(0, 512, (6, 2))
    caches = [m.initialize_inference_params(2, 64)
              for m in (model, plain_model)]
    for i, m in enumerate((model, plain_model)):
        _, caches[i] = m(ids, inference_params_dict=caches[i])
    for tok in steps:
        got, caches[0] = model(tok[:, None], inference_params_dict=caches[0])
        want, caches[1] = plain_model(tok[:, None],
                                      inference_params_dict=caches[1])
        _close(got, want, **QUANT_TOL)
        assert float((got - want).abs().max()) > 0
    assert caches[0]['offset'] == caches[1]['offset'] == 46


def test_segmented_scores_int8_close_to_monolithic(setup):
    model, _, tok, _, _ = setup
    rng = np.random.default_rng(4)
    seqs = [''.join(rng.choice(list('ACGT'), n)) for n in (150, 70)]
    want = [score_sequences([s], model, tok)[0] for s in seqs]
    got = score_sequences_segmented(seqs, model, tok, segment_len=32)
    # mean log-likelihoods near -6.2: the int8 read-back moves them in the
    # 6th digit here; 1e-3 relative leaves room and still catches a fault
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got != want


@pytest.mark.parametrize('chunks', [(5, 7), (1, 1, 10)])
def test_generation_int8_resumed_in_chunks_is_token_exact(setup, chunks):
    """One call and a chain of resumed calls read the same int8 cache: the
    resumed call's one-token prefill attends the buffer as a decode step
    does. Tokens equal, logits within 1e-4."""
    model, _, tok, _, _ = setup
    rng = np.random.default_rng(5)
    prompt = ''.join(rng.choice(list('ACGT'), 50))
    g = Generator(model, tok, top_k=1)
    want, want_scores, _ = g.generate(prompt, num_tokens=sum(chunks))
    toks, scores, cache = g.generate(prompt, num_tokens=chunks[0])
    parts, score_parts = [toks], [scores]
    for n in chunks[1:]:
        codes = cache['layers'][1]['k'].clone()
        toks, scores, new_cache = g.generate(
            input_ids=parts[-1][:, -1:], num_tokens=n,
            inference_params_dict=cache)
        assert torch.equal(cache['layers'][1]['k'], codes)   # caller's kept
        parts.append(toks)
        score_parts.append(scores)
        cache = new_cache
    assert torch.equal(torch.cat(parts, dim=1), want)
    _close(torch.cat(score_parts, dim=1), want_scores, **LOGIT_TOL)


def test_generation_int8_with_prefill_segments(setup):
    """Segments attend the int8 buffer where the one-pass prefill attends
    unquantised k and v: logits within the quantisation limit."""
    model, _, tok, _, _ = setup
    rng = np.random.default_rng(6)
    prompt = ''.join(rng.choice(list('ACGT'), 100))
    g = Generator(model, tok, top_k=1)
    _, want_scores, _ = g.generate(prompt, num_tokens=4)
    _, scores, cache = g.generate(prompt, num_tokens=4,
                                  prefill_segment_len=32)
    _close(scores, want_scores, **QUANT_TOL)
    assert cache['offset'] == 103 and _cache_kv_len(cache) == 128


def test_grow_cache_int8_layout(setup):
    model, _, _, _, _ = setup
    cache = model.initialize_inference_params(1, 16)
    _, cache = model(np.ones((1, 9), np.int32), inference_params_dict=cache)
    grown = _grow_cache(cache, 40)
    layer = grown['layers'][1]
    assert layer['k'].shape == (1, 4, 40, 16) and layer['k'].dtype == torch.int8
    assert layer['ks'].shape == (1, 4, 40)
    for name in layer:
        assert torch.equal(layer[name][:, :, :16], cache['layers'][1][name])
        assert not layer[name][:, :, 16:].any()
    # the grown cache resumes like the original
    tok = np.array([[5]], np.int32)
    want, _ = model(tok, inference_params_dict=_grow_cache(cache, 16))
    got, _ = model(tok, inference_params_dict=grown)
    _close(got, want)
    assert model_lib.init_cache(model.config, 1, 8, 'cpu')['layers'][1][
        'vs'].dtype == torch.float32
