"""The FFT long-conv backend of the PyTorch port (`hyena_conv_backend=
'fft'`, `hyena_fft_chunk`, `state_prefill_chunk`) against the JAX
package's, on the CPU in float32 at tiny widths, inputs from numpy seeds:

  * `materialize_filter`, `fft_causal_conv`, `fft_causal_conv_chunked`
    (fresh with left padding, continued from a state, and the ValueError
    for a state with padding) and `modal_prefill_state` (with left padding)
    against their JAX counterparts (rtol 1e-5), and against the O(L^2)
    oracles `direct_causal_conv` / `materialize_filter_direct`;
  * the tiny model's forward under 'fft' against JAX `forward` with the
    same config, with the chunk at 0 and at 8 (tests/test_golden.py's 1e-4
    on logits); a prefill of 13 then decode steps to 20 under chunk 8
    against JAX `prefill` / `decode_step` (tests/test_model.py:128-144:
    2e-4 on the prefill, 2e-3 a step); the Hyena layer continued from a
    carried state, and prefill in segments, against JAX's; greedy tokens
    equal to JAX's; `hyena_fused_mixer=True` ignored under 'fft';
  * a full train step's first loss and every gradient against jax.grad
    through the JAX FFT backend (scaled error <= 1e-4), a LoRA step over
    the same base, and the FFT functions' gradients under a lowered float32
    precision bit-equal to the pinned ones.

The cp = 2 forward under 'fft' rides the launches of
tests/test_torch_context_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu import training as jax_training
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.generation import generate as jax_generate
from evo_tpu.layers import hyena as jax_hyena
from evo_tpu.models import EvoModel as JaxEvoModel
from evo_tpu.ops import fftconv as jax_fftconv
from evo_tpu_torch import lora, training
from evo_tpu_torch.checkpoint import cache_to_jax, params_from_state_dict
from evo_tpu_torch.config import ModelConfig, tiny_config
from evo_tpu_torch.generation import generate
from evo_tpu_torch.layers import hyena
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.ops import fftconv
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
FFT = dict(hyena_conv_backend='fft')


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _modal(rng, D, S):
    """Stable random poles and residues, (D, S, 2) float32, numpy."""
    mag = rng.uniform(0.5, 0.98, (D, S))
    ang = rng.uniform(-np.pi, np.pi, (D, S))
    poles = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1)
    return (poles.astype(np.float32),
            (rng.standard_normal((D, S, 2)) * 0.3).astype(np.float32))


def _inputs(seed, B, D, L, S=4):
    rng = np.random.default_rng(seed)
    poles, residues = _modal(rng, D, S)
    u = rng.standard_normal((B, D, L)).astype(np.float32)
    return u, poles, residues


# the JAX primitives compiled once a shape: eager JAX compiles each
# operation apart, which takes longer here
J = dict(
    materialize_filter=jax.jit(jax_fftconv.materialize_filter,
                               static_argnums=(2, 3)),
    materialize_filter_direct=jax.jit(jax_fftconv.materialize_filter_direct,
                                      static_argnums=2),
    fft_causal_conv=jax.jit(jax_fftconv.fft_causal_conv),
    fft_causal_conv_chunked=jax.jit(jax_fftconv.fft_causal_conv_chunked,
                                    static_argnums=3),
    modal_prefill_state=jax.jit(jax_fftconv.modal_prefill_state,
                                static_argnums=2))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# -- the primitives --------------------------------------------------------

@pytest.mark.parametrize('L,block', [(1, 128), (37, 8), (300, 128),
                                     (256, 16)])
def test_materialize_filter_matches_jax(L, block):
    _, poles, residues = _inputs(L, 1, 8, 1)
    got = fftconv.materialize_filter(*_t(poles, residues), L, block=block)
    assert got.shape == (8, L) and got.dtype == torch.float32
    _close(got, J['materialize_filter'](*_j(poles, residues), L, block))
    direct = fftconv.materialize_filter_direct(*_t(poles, residues), L)
    _close(direct, J['materialize_filter_direct'](*_j(poles, residues), L))
    _close(got, direct)


@pytest.mark.parametrize('B,D,L', [(2, 8, 1), (1, 8, 37), (2, 4, 64)])
def test_fft_causal_conv_matches_jax_and_direct(B, D, L):
    u, poles, residues = _inputs(L + D, B, D, L)
    h = J['materialize_filter'](*_j(poles, residues), L, 128)
    h_t = torch.from_numpy(np.array(h))
    got = fftconv.fft_causal_conv(torch.from_numpy(u), h_t)
    assert got.shape == (B, D, L) and got.dtype == torch.float32
    _close(got, J['fft_causal_conv'](jnp.asarray(u), h))
    _close(got, fftconv.direct_causal_conv(torch.from_numpy(u), h_t))
    # a bf16 input is convolved in float32
    ub = torch.from_numpy(u).bfloat16()
    _close(fftconv.fft_causal_conv(ub, h_t),
           J['fft_causal_conv'](jnp.asarray(ub.float().numpy(),
                                            jnp.bfloat16), h))


@pytest.mark.parametrize('L,chunk', [(37, 8), (64, 16), (5, 8), (48, 48)])
def test_fft_conv_chunked_fresh_matches_jax(L, chunk):
    """A fresh L, left-padded where the chunk does not divide it: y and
    the state at L against JAX's, y against the monolithic direct conv,
    the state against `modal_prefill_state`."""
    u, poles, residues = _inputs(L, 2, 8, L)
    y, st = fftconv.fft_causal_conv_chunked(*_t(u, poles, residues), chunk)
    y_j, st_j = J['fft_causal_conv_chunked'](*_j(u, poles, residues), chunk)
    assert y.shape == (2, 8, L) and st.shape == (2, 8, 4, 2)
    _close(y, y_j)
    _close(st, st_j)
    h = fftconv.materialize_filter_direct(*_t(poles, residues), L)
    _close(y, fftconv.direct_causal_conv(torch.from_numpy(u), h))
    _close(st, fftconv.modal_prefill_state(*_t(u, poles), 8))


@pytest.mark.parametrize('first,rest,chunk', [(16, 32, 8), (21, 16, 16),
                                              (8, 5, 8)])
def test_fft_conv_chunked_continued_matches_jax(first, rest, chunk):
    """A segment continued from the state of the one before (its length a
    multiple of the chunk, or shorter than one chunk): against JAX's and
    against the whole sequence in one pass."""
    u, poles, residues = _inputs(first + rest, 2, 8, first + rest)
    ut, pt, rt = _t(u, poles, residues)
    uj, pj, rj = _j(u, poles, residues)
    _, st = fftconv.fft_causal_conv_chunked(ut[..., :first], pt, rt, chunk)
    _, st_j = J['fft_causal_conv_chunked'](uj[..., :first], pj, rj, chunk)
    y, st2 = fftconv.fft_causal_conv_chunked(ut[..., first:], pt, rt, chunk,
                                             state=st)
    y_j, st2_j = J['fft_causal_conv_chunked'](uj[..., first:], pj, rj,
                                              chunk, st_j)
    _close(y, y_j)
    _close(st2, st2_j)
    whole, st_whole = fftconv.fft_causal_conv_chunked(ut, pt, rt,
                                                      first + rest)
    _close(y, whole[..., first:])
    _close(st2, st_whole)


def test_fft_conv_chunked_refuses_a_state_with_padding():
    u, poles, residues = _inputs(0, 1, 4, 12)
    ut, pt, rt = _t(u, poles, residues)
    state = fftconv.modal_state_init(1, 4, 4)
    assert state.shape == (1, 4, 4, 2) and not state.any()
    with pytest.raises(ValueError) as port_err:
        fftconv.fft_causal_conv_chunked(ut, pt, rt, 8, state=state)
    with pytest.raises(ValueError) as jax_err:
        jax_fftconv.fft_causal_conv_chunked(
            *_j(u, poles, residues), 8,
            state=jax_fftconv.modal_state_init(1, 4, 4))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize('L,chunk', [(37, 8), (32, 8), (3, 128), (100, 32)])
def test_modal_prefill_state_matches_jax(L, chunk):
    """Left padding where the chunk does not divide L; against JAX's and
    against the recurrence of the decode step run over every sample."""
    u, poles, residues = _inputs(L + chunk, 2, 8, L)
    got = fftconv.modal_prefill_state(*_t(u, poles), chunk)
    _close(got, J['modal_prefill_state'](*_j(u, poles), chunk))
    st = fftconv.modal_state_init(2, 8, 4)
    zeros = torch.zeros(8)
    for t in range(L):
        _, st = fftconv.modal_step(torch.from_numpy(u[..., t]),
                                   *_t(poles, residues), zeros, st)
    _close(got, st)


@pytest.mark.parametrize('setting', ['high', 'medium'])
def test_fft_backend_gradients_keep_full_float32(setting):
    """The FFT functions' forward and gradients are taken at the 'highest'
    float32 precision whatever the global setting, as the matmul conv's
    are (tests/test_torch_training.py)."""
    u, poles, residues = _inputs(11, 2, 8, 40)
    gy = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 8, 40)).astype(np.float32))
    before = torch.get_float32_matmul_precision()
    grads = []
    try:
        for prec in ('highest', setting):
            torch.set_float32_matmul_precision(prec)
            leaves = [t.clone().requires_grad_()
                      for t in _t(u, poles, residues)]
            h = fftconv.materialize_filter(leaves[1], leaves[2], 40,
                                           block=8)
            y = fftconv.fft_causal_conv(leaves[0], h)
            y2, st = fftconv.fft_causal_conv_chunked(*leaves, 16)
            st2 = fftconv.modal_prefill_state(leaves[0], leaves[1], 16)
            loss = ((y + y2) * gy).sum() + (st * st2).sum()
            grads.append(torch.autograd.grad(loss, leaves))
            assert torch.get_float32_matmul_precision() == prec
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# -- the model ---------------------------------------------------------------

@pytest.fixture(scope='module')
def setup():
    """The tiny config's PRNGKey(0) weights in both packages, and the JAX
    entry points compiled once a config and shape (eager JAX compiles each
    operation apart, which takes longer here)."""
    jcfg = jax_tiny_config()
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    fns = dict(
        forward=jax.jit(jax_model.forward, static_argnums=1),
        prefill=jax.jit(jax_model.prefill, static_argnums=1,
                        static_argnames=('resume',)),
        decode_step=jax.jit(jax_model.decode_step, static_argnums=1),
        hyena_full=jax.jit(jax_hyena.hyena_full, static_argnums=1,
                           static_argnames=('collect_state',)))
    return params, sd, fns


def _models(setup, **overrides):
    params, sd, _ = setup
    jcfg = jax_tiny_config(**overrides)
    cfg = tiny_config(**overrides)
    return (JaxEvoModel(jcfg, params), jcfg,
            EvoModel(cfg, params_from_state_dict(sd, cfg, 'cpu')))


@pytest.mark.parametrize('chunk', [0, 8])
def test_forward_matches_jax(setup, chunk):
    params, _, jfn = setup
    jm, jcfg, model = _models(setup, hyena_fft_chunk=chunk, **FFT)
    ids = np.random.default_rng(9).integers(0, 512, (2, 21)).astype(np.int32)
    want = jfn['forward'](params, jcfg, jnp.asarray(ids))
    got, _ = model(ids)
    _close(got, want, **LOGIT_TOL)
    # the two backends compute one function
    _, _, matmul = _models(setup)
    _close(got, matmul(ids)[0], **LOGIT_TOL)


def test_prefill_then_decode_matches_jax(setup):
    """tests/test_model.py:128-144 under the FFT backend in both packages:
    a chunked prefill of 13 (L > 8), then decode steps to 20."""
    params, _, jfn = setup
    jm, jcfg, model = _models(setup, hyena_fft_chunk=8, **FFT)
    total, split = 20, 13
    ids = np.random.default_rng(10).integers(0, 512, (1, total)).astype(
        np.int32)
    full, _ = model(ids)
    _close(full, jfn['forward'](params, jcfg, jnp.asarray(ids)), **LOGIT_TOL)
    jcache = jax_model.init_cache(jcfg, 1, total + 2)
    lg_j, jcache = jfn['prefill'](params, jcfg, jnp.asarray(ids[:, :split]),
                                  jcache)
    cache = model.initialize_inference_params(1, total + 2)
    lg, cache = model(ids[:, :split], inference_params_dict=cache)
    _close(lg, lg_j, rtol=2e-4, atol=2e-4)
    _close(lg, full[:, :split], rtol=2e-4, atol=2e-4)
    for t in range(split, total):
        last_j, jcache = jfn['decode_step'](params, jcfg,
                                            jnp.asarray(ids[:, t]), jcache)
        last, cache = model(ids[:, t:t + 1], inference_params_dict=cache)
        _close(last[:, 0], last_j, rtol=2e-3, atol=2e-3)
        _close(last[:, 0], full[:, t], rtol=2e-3, atol=2e-3)


def test_monolithic_prefill_state_matches_jax(setup):
    """Chunk 0: one FFT, then the state scanned in chunks of
    state_prefill_chunk (32 in the tiny config; 5 here, so that it pads)."""
    params, _, jfn = setup
    jm, jcfg, model = _models(setup, state_prefill_chunk=5, **FFT)
    ids = np.random.default_rng(11).integers(0, 512, (2, 17)).astype(
        np.int32)
    _, jcache = jfn['prefill'](params, jcfg, jnp.asarray(ids),
                               jax_model.init_cache(jcfg, 2, 20))
    _, cache = model(ids, inference_params_dict=model.
                     initialize_inference_params(2, 20))
    got = jax.tree_util.tree_leaves(cache_to_jax(cache, model.config))
    want = jax.tree_util.tree_leaves(jcache)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize('lengths', [
    (16, 24),            # continued segments, multiples of the chunk
    (21, 12, 5),         # L > chunk not a multiple, then one chunk of L
    (5, 2, 1, 40),       # below the FIR width with a carried tail
])
def test_hyena_full_with_state_matches_jax(setup, lengths):
    params, _, jfn = setup
    jm, jcfg, model = _models(setup, hyena_fft_chunk=8, **FFT)
    jp = jax_model.layer_blocks(params, jcfg)[0]['hyena']
    tp, cfg = model.module.blocks[0].hyena, model.config
    rng = np.random.default_rng(sum(lengths))
    x = rng.standard_normal((2, sum(lengths), 64)).astype(np.float32)
    x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    whole, whole_st = hyena.hyena_full(tp, cfg, x_t, collect_state=True)
    st_j = st_t = None
    s = 0
    for L in lengths:
        y_j, st_j = jfn['hyena_full'](jp, jcfg, x_j[:, s:s + L],
                                      collect_state=True, state=st_j)
        y_t, st_t = hyena.hyena_full(tp, cfg, x_t[:, s:s + L],
                                     collect_state=True, state=st_t)
        _close(y_t, y_j)
        _close(y_t, whole[:, s:s + L])
        _close(st_t.fir, st_j.fir)
        _close(st_t.iir, st_j.iir)
        s += L
    _close(st_t.iir, whole_st.iir)


def test_segmented_prefill_matches_jax(setup):
    """Segments of 13, 16 (two chunks with a carried state) and 8 (one
    chunk of L): the logits of each against JAX's."""
    params, _, jfn = setup
    jm, jcfg, model = _models(setup, hyena_fft_chunk=8, **FFT)
    bounds = (0, 13, 29, 37)
    ids = np.random.default_rng(12).integers(0, 512, (2, bounds[-1])).astype(
        np.int32)
    cache = model.initialize_inference_params(2, 48)
    jcache = jax_model.init_cache(jcfg, 2, 48)
    for s, e in zip(bounds[:-1], bounds[1:]):
        want, jcache = jfn['prefill'](params, jcfg, jnp.asarray(ids[:, s:e]),
                                      jcache, resume=s > 0)
        got, cache = model(ids[:, s:e], inference_params_dict=cache,
                           resume=s > 0)
        _close(got, want, **LOGIT_TOL)


def test_greedy_tokens_equal_jax(setup):
    jm, _, model = _models(setup, **FFT)
    tok = CharLevelTokenizer(512)
    want, _ = jax_generate(['ACGTACGTAAC'], jm, tok, n_tokens=12, top_k=1,
                           verbose=0)
    got, _ = generate(['ACGTACGTAAC'], model, tok, n_tokens=12, top_k=1,
                      verbose=0)
    assert got == want


def test_fused_mixer_is_ignored_under_fft(setup, monkeypatch):
    """As at evo_tpu/layers/hyena.py:115: the fused core runs under the
    matmul backend only."""
    _, _, model = _models(setup, **FFT)
    _, _, fused = _models(setup, hyena_fused_mixer=True, **FFT)

    def refuse(*a, **kw):
        raise AssertionError('the fused mixer ran under the FFT backend')
    monkeypatch.setattr(hyena, 'hyena_mixer', refuse)
    ids = np.random.default_rng(13).integers(0, 512, (1, 32))
    assert torch.equal(fused(ids)[0], model(ids)[0])


def test_backend_is_validated():
    with pytest.raises(ValueError, match='hyena_conv_backend'):
        tiny_config(hyena_conv_backend='toeplitz')
    cfg = ModelConfig.from_dict(dict(hyena_conv_backend='fft',
                                     hyena_fft_chunk=64))
    assert cfg.hyena_conv_backend == 'fft' and cfg.hyena_fft_chunk == 64


# -- training ------------------------------------------------------------------

def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def test_train_steps_under_fft_match_jax(setup):
    """The first loss and every gradient of a full train step against
    jax.grad through the JAX FFT backend (the tiny config, chunk 8 so that
    both the chunked and, in the LoRA step's shorter window, the
    monolithic conv run); then a LoRA step over the same base, whose
    fresh adapters leave the first loss the base model's."""
    params, sd, _ = setup
    jcfg = jax_tiny_config(hyena_fft_chunk=8, **FFT)
    cfg = tiny_config(hyena_fft_chunk=8, **FFT)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_training.next_token_loss(
            p, jcfg, jnp.asarray(ids), jnp.asarray(mask))))(params)
    want = {'embedding': grads_j['embedding'],
            'final_norm.weight': grads_j['final_norm']}
    for i, blk in enumerate(jax_model.layer_blocks(grads_j, jcfg)):
        for norm in ('pre_norm', 'post_norm'):
            want[f'blocks.{i}.{norm}.weight'] = blk[norm]
        for sub in ('attn', 'hyena', 'mlp'):
            for k, v in blk.get(sub, {}).items():
                want[f'blocks.{i}.{sub}.{k}'] = v
    model = params_from_state_dict(sd, cfg, 'cpu')
    params_t = dict(model.named_parameters())
    training.set_trainable(params_t.values(), True)
    training.next_token_loss(model, None, ids, mask).backward()
    training.set_trainable(params_t.values(), False)
    assert set(params_t) == set(want)
    for name, p in params_t.items():
        assert _scaled(p.grad.numpy(), want[name]) <= 1e-4, name
    # the train step itself: its first loss is the JAX loss
    model = params_from_state_dict(sd, cfg, 'cpu')
    opt = training.make_optimizer(learning_rate=1e-3)
    state, loss = training.make_train_step(model, opt)(
        training.init_train_state(model, opt), ids, mask)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert state.step == 1
    # LoRA over the base, on a window of 6 (one monolithic FFT a layer)
    model = params_from_state_dict(sd, cfg, 'cpu')
    base = float(training.next_token_loss(model, None, ids[:, :6],
                                          mask[:, :6]))
    ad = lora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    opt = training.make_optimizer(learning_rate=1e-3)
    step = lora.make_lora_train_step(model, opt)
    state, loss = step(lora.init_lora_train_state(ad, opt), ids[:, :6],
                       mask[:, :6])
    assert float(loss) == base
    state, loss2 = step(state, ids[:, :6], mask[:, :6])
    assert float(loss2) < base
