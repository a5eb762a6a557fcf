"""The PyTorch port's n-gram speculative decoding
(`evo_tpu_torch/speculative.py`) against the JAX package's
(`evo_tpu/speculative.py`) and against the port's own greedy `Generator`,
on the CPU in float32 at tiny widths (weights carried across by
`export_state_dict` -> `params_from_state_dict`, caches by
`cache_to_jax`).

Limits. The host parts are the same numpy code: `NGramIndex` proposals,
`filtered_probs` and `accept_or_resample` decisions bit-equal. Greedy
tokens exact, against the Generator and against JAX; `SpecStats` equal
field for field; log-probs within 1e-4 of JAX's (the two packages' float32
logits differ by ~1e-6). A seeded sampled stream token for token equal to
JAX's: both draw from `np.random.default_rng(seed)` on the same
distributions. The cache after a cycle equals a direct prefill of what it
consumed, in the port and in the JAX package: Hyena states within 1e-5
relative and absolute (float32 modal states of size ~1-3; a replay and a
fresh prefill sum in other orders), KV rows below the offset within 1e-5,
int8 codes within one level.

On random weights the n-gram drafter is almost never right, so the paths
of full and partial acceptance are driven by an oracle drafter: it
proposes the true greedy continuation, wrong at a scheduled place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.speculative as jax_spec
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.models import EvoModel as JaxEvoModel
from evo_tpu.ops import sampling as jax_sampling
from evo_tpu_torch import generate_speculative
from evo_tpu_torch import model as model_lib
from evo_tpu_torch import speculative as spec
from evo_tpu_torch.checkpoint import cache_to_jax, params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.generation import Generator
from evo_tpu_torch.layers.hyena import HyenaState
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.ops.sampling import NEG_INF, top_k_filter, top_p_filter
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
REPETITIVE = 'ACGTACGTACGTACGTACGT'
ADVERSARIAL = 'AGTCCATGAACGTTAGCATGCAATCGGATC'     # no repeated 3-grams


def _models(jcfg, cfg, params):
    module = params_from_state_dict(jax_ckpt.export_state_dict(params, jcfg),
                                    cfg, 'cpu')
    return EvoModel(cfg, module), JaxEvoModel(jcfg, params)


@pytest.fixture(scope='module')
def setup():
    """(port model, JAX model, tokenizer) on one set of weights."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    return (*_models(jcfg, cfg, params), CharLevelTokenizer(512))


@pytest.fixture(scope='module')
def setup_int8():
    """The same under the int8 KV cache."""
    jcfg = jax_tiny_config(kv_quant='int8')
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    return (*_models(jcfg, tiny_config(kv_quant='int8'), params),
            CharLevelTokenizer(512))


def _greedy(model, tok, prompt, n):
    gen, scores, _ = Generator(model, tok, top_k=1, temperature=0.0).generate(
        input_ids=np.asarray(tok.tokenize(prompt))[None], num_tokens=n)
    return gen[0].numpy(), scores[0].numpy()


def _oracle(stream, prompt_len, schedule):
    """A `propose` that continues the true greedy `stream` and is wrong at
    position schedule[c] of cycle c (right throughout where schedule[c]
    >= gamma)."""
    cycle = [0]

    def propose(self, gamma):
        pos = len(self.tokens) - prompt_len
        true = [int(t) for t in stream[pos:pos + gamma]]
        a = schedule[cycle[0] % len(schedule)]
        cycle[0] += 1
        if a < gamma:
            true[a] = (true[a] + 1) % 512       # never the argmax
        return np.asarray(true, np.int32)
    return propose


class _Recorder:
    """The engine facade, recording each call's length and keywords and
    the last cache it returned."""

    def __init__(self, model):
        self.model = model
        self.calls = []
        self.cache = None

    def initialize_inference_params(self, batch_size, max_len):
        self.cache = self.model.initialize_inference_params(batch_size,
                                                            max_len)
        return self.cache

    def __call__(self, ids, **kw):
        logits, self.cache = self.model(ids, **kw)
        self.calls.append((np.asarray(ids).shape[1], kw['donate_cache'],
                           kw['resume']))
        return logits, self.cache


def _same_run(got, want, tol=1e-4):
    """Tokens exact, stats field for field, log-probs within tol."""
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].dtype == np.int32 and got[0].shape == np.shape(want[0])
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol)


# -- the host parts -----------------------------------------------------------

def _streams():
    rng = np.random.default_rng(0)
    unit = rng.integers(0, 4, 97).tolist()
    return {
        'random-dna': rng.integers(65, 69, 600).tolist(),
        'tandem': unit * 6 + unit[:40],
        'wide-ids': rng.integers(0, 2048, 300).tolist(),   # ids alias
    }


@pytest.mark.parametrize('name', sorted(_streams()))
@pytest.mark.parametrize('n,n_min,window', [(2, None, 32768), (12, 4, 32768),
                                            (12, 4, 64), (3, 1, 16)])
def test_ngram_index_matches_jax(name, n, n_min, window):
    """Proposals at every step of a seeded stream, the longest-match order
    and the window's eviction (small windows rebuild the index many
    times), against the JAX index."""
    stream = _streams()[name]
    ours = spec.NGramIndex(n, n_min=n_min, window=window)
    theirs = jax_spec.NGramIndex(n, n_min=n_min, window=window)
    for i in range(0, len(stream), 7):
        ours.extend(stream[i:i + 7])
        theirs.extend(stream[i:i + 7])
        for gamma in (1, 4, 9):
            np.testing.assert_array_equal(ours.propose(gamma),
                                          theirs.propose(gamma))
        assert ours._index == theirs._index
        assert (ours._index_base, ours._indexed_upto) == (
            theirs._index_base, theirs._indexed_upto)
    assert all(len(d) <= 2 * ours.window for d in ours._index.values())


@pytest.mark.parametrize('temp,k,p_nuc', [(0.7, 4, 1.0), (1.0, 0, 0.6),
                                          (0.5, 8, 0.9), (1.3, 1, 0.3),
                                          (1.0, 0, 1.0)])
def test_filtered_probs_bit_equal_and_kept_set_of_the_port_filter(
        temp, k, p_nuc):
    rng = np.random.default_rng(0)
    for _ in range(5):
        logits = (rng.normal(size=24) * 3).astype(np.float32)
        got = spec.filtered_probs(logits, temp, k, p_nuc)
        np.testing.assert_array_equal(
            got, jax_spec.filtered_probs(logits, temp, k, p_nuc))
        assert got.dtype == np.float64
        # the kept set is the one of ops/sampling's filters (and of the
        # JAX package's on-device filters)
        z = torch.from_numpy(logits)[None] / temp
        kept = top_p_filter(top_k_filter(z, k), p_nuc)[0] > NEG_INF / 2
        np.testing.assert_array_equal(got > 0, kept.numpy())
        jz = jax_sampling.top_p_filter(jax_sampling.top_k_filter(
            jnp.asarray(logits) / temp, k), p_nuc)
        np.testing.assert_array_equal(got > 0, np.asarray(jz) > -1e9)


def test_accept_or_resample_takes_the_jax_decisions():
    draws = np.random.default_rng(5)
    for seed in range(20):
        p = draws.dirichlet(np.full(8, 0.5))
        if seed == 0:
            p = np.eye(8)[3]                       # a point mass
        ours, theirs = (np.random.default_rng(seed),
                        np.random.default_rng(seed))
        for step in range(50):
            proposal = (seed + step) % 8
            assert spec.accept_or_resample(ours, p, proposal) == \
                jax_spec.accept_or_resample(theirs, p, proposal)


def test_accept_or_resample_preserves_target_distribution():
    """The JAX test's marginal check on the port's function: the emitted
    token is p-distributed whatever the proposal."""
    p = np.asarray([0.5, 0.25, 0.15, 0.1])
    for proposal in range(4):
        rng = np.random.default_rng(proposal)
        counts = np.zeros(4)
        n = 200_000
        for _ in range(n):
            _, tok = spec.accept_or_resample(rng, p, proposal)
            counts[tok] += 1
        np.testing.assert_allclose(counts / n, p, atol=5e-3)


def test_spec_stats_properties():
    s = spec.SpecStats(cycles=4, proposed=16, accepted=6, device_calls=7)
    j = jax_spec.SpecStats(cycles=4, proposed=16, accepted=6, device_calls=7)
    assert (s.acceptance_rate, s.tokens_per_call) == (j.acceptance_rate,
                                                      j.tokens_per_call)
    assert spec.SpecStats().acceptance_rate == 0.0


# -- greedy: against the Generator and the JAX package ------------------------

@pytest.mark.parametrize('prompt', [REPETITIVE, ADVERSARIAL],
                         ids=['repetitive', 'adversarial'])
@pytest.mark.parametrize('gamma,ngram', [(1, 2), (4, 3), (8, 3)])
def test_greedy_matches_generator_and_jax(setup, prompt, gamma, ngram):
    model, jmodel, tok = setup
    n = 24
    want, scores = _greedy(model, tok, prompt, n)
    got = generate_speculative(model, tok, prompt=prompt, num_tokens=n,
                               gamma=gamma, ngram=ngram)
    np.testing.assert_array_equal(got[0], want)
    _same_run(got, jax_spec.generate_speculative(
        jmodel, tok, prompt=prompt, num_tokens=n, gamma=gamma, ngram=ngram))
    # the log-probs are the Generator's step logits at the emitted tokens
    lg = scores.astype(np.float64)
    m = lg.max(-1, keepdims=True)
    ref = lg - m - np.log(np.exp(lg - m).sum(-1, keepdims=True))
    np.testing.assert_allclose(got[1], ref[np.arange(n), want], atol=1e-4)
    assert got[2].cycles >= 1


@pytest.mark.parametrize('gamma,schedule,n', [
    (4, [4, 0, 2, 4, 1, 3], 30),      # full, a replay of 1, 2, 3 and 4
    (8, [8, 8, 5, 0, 7], 40),
    (1, [1, 0], 12)])
def test_partial_and_full_acceptance_match_jax(setup, monkeypatch, gamma,
                                               schedule, n):
    """An oracle drafter takes both packages through full acceptance and
    every replay length; the runs agree token for token, in their stats
    and in their log-probs, and the tokens are the Generator's."""
    model, jmodel, tok = setup
    stream, _ = _greedy(model, tok, REPETITIVE, n + gamma + 1)
    P = len(REPETITIVE)
    monkeypatch.setattr(spec.NGramIndex, 'propose',
                        _oracle(stream, P, schedule))
    rec = _Recorder(model)
    got = generate_speculative(rec, tok, prompt=REPETITIVE, num_tokens=n,
                               gamma=gamma)
    monkeypatch.setattr(jax_spec.NGramIndex, 'propose',
                        _oracle(stream, P, schedule))
    _same_run(got, jax_spec.generate_speculative(
        jmodel, tok, prompt=REPETITIVE, num_tokens=n, gamma=gamma))
    np.testing.assert_array_equal(got[0], stream[:n])
    stats = got[2]
    assert stats.accepted > 0 and stats.accepted < stats.proposed
    # the engine calls: one fresh prefill, then each cycle a verify pass
    # of gamma + 1 (not donated) and, on partial acceptance, a donated
    # replay of a + 1 positions
    assert rec.calls[0] == (P, True, False)
    replays = [c for c in rec.calls[1:] if c[1]]
    verifies = [c for c in rec.calls[1:] if not c[1]]
    assert verifies == [(gamma + 1, False, True)] * stats.cycles
    assert all(c[2] and 1 <= c[0] <= gamma for c in replays)
    assert len(rec.calls) == stats.device_calls


def _prefilled(model, segments, T, to_device=np.asarray):
    """A cache of length T that has consumed `segments` in order: the
    first by a fresh prefill, the others resumed."""
    cache = model.initialize_inference_params(1, T)
    for i, seg in enumerate(segments):
        _, cache = model(to_device(seg[None]), inference_params_dict=cache,
                         donate_cache=True, resume=i > 0)
    return cache


def _assert_caches_equal(got, want):
    assert got['offset'] == want['offset']
    o = want['offset']
    for g, w in zip(got['layers'], want['layers']):
        if isinstance(w, HyenaState):
            for a, b in zip(g, w):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-5)
            continue
        if 'ks' not in w:
            for name in ('k', 'v'):
                np.testing.assert_allclose(g[name][:, :o].numpy(),
                                           w[name][:, :o].numpy(), rtol=0,
                                           atol=1e-5)
            continue
        for name in ('k', 'v'):
            codes = (g[name][:, :, :o].int() - w[name][:, :, :o].int()).abs()
            assert int(codes.max()) <= 1
            np.testing.assert_allclose(g[name + 's'][:, :, :o].numpy(),
                                       w[name + 's'][:, :, :o].numpy(),
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize('kv', ['bf16-layout', 'int8'])
@pytest.mark.parametrize('a', [0, 1, 3, 4])
def test_cache_after_a_cycle_equals_a_direct_prefill(setup, setup_int8,
                                                     monkeypatch, kv, a):
    """One verify pass with a accepted of 4 (a = 4: full acceptance), and
    the cache it leaves against a direct prefill of the prompt and every
    emitted token but the last, in the port and in the JAX package:
    offset, each HyenaState within 1e-5 (relative and absolute: the modal
    states are of size ~1-3; 1e-4 against JAX under the int8 cache), the
    KV rows below the offset. This guards
    the shallow save: a Hyena state written in place, or a restore that
    missed the offset or a layer, leaves the state of the rejected
    proposal here. Under the int8 cache the direct prefill takes the
    prompt and the emitted tokens as two segments, as the speculative run
    did: a fresh pass attends its own unquantized keys, a resumed one the
    cache's int8 codes, which moves the states by ~2e-3."""
    model, jmodel, tok = setup if kv != 'int8' else setup_int8
    gamma, P = 4, len(ADVERSARIAL)
    stream, _ = _greedy(model, tok, ADVERSARIAL, 2 + gamma)
    monkeypatch.setattr(spec.NGramIndex, 'propose',
                        _oracle(stream, P, [a]))
    rec = _Recorder(model)
    n = 1 + a + 1
    toks, _, stats = generate_speculative(rec, tok, prompt=ADVERSARIAL,
                                          num_tokens=n, gamma=gamma)
    assert (stats.cycles, stats.accepted) == (1, a)
    assert stats.device_calls == (2 if a == gamma else 3)
    np.testing.assert_array_equal(toks, stream[:n])
    T = P + n + gamma + 2
    prompt_ids = np.asarray(tok.tokenize(ADVERSARIAL))
    segments = ([prompt_ids, toks[:-1]] if kv == 'int8'
                else [np.concatenate([prompt_ids, toks[:-1]])])
    want = _prefilled(model, segments, T)
    _assert_caches_equal(rec.cache, want)
    jcache = _prefilled(jmodel, segments, T, jnp.asarray)
    o = want['offset']
    assert int(jcache['offset']) == o
    # an int8 code the two packages round apart at a tie moves the states
    # after it by ~2e-5: 1e-4 there, as for logits
    tol = 1e-4 if kv == 'int8' else 1e-5
    for g, w in zip(cache_to_jax(rec.cache, model.config)['layers'],
                    jcache['layers']):
        if not isinstance(g, dict):             # a Hyena run: fir, iir
            for a_, b_ in zip(g, w):
                np.testing.assert_allclose(a_, np.asarray(b_), rtol=tol,
                                           atol=tol)
            continue
        for name, t in g.items():
            if t.dtype == np.int8:
                continue                        # codes: held above
            live = (t[:, :, :o] if name in ('ks', 'vs')
                    else t[:, :o])
            ref = np.asarray(w[name])
            ref = ref[:, :, :o] if name in ('ks', 'vs') else ref[:, :o]
            np.testing.assert_allclose(live, ref, rtol=1e-4, atol=1e-5)


class _Spy(_Recorder):
    """A recorder that also keeps the KV buffers' addresses after each
    call, and before each verify pass the Hyena states of the cache with
    a copy of their values."""

    def __init__(self, model):
        super().__init__(model)
        self.kv, self.saved = [], []

    def __call__(self, ids, **kw):
        if not kw['donate_cache']:
            self.saved.append([(s, [t.clone() for t in s])
                               for s in self.cache['layers']
                               if isinstance(s, HyenaState)])
        out = super().__call__(ids, **kw)
        self.kv.append([t.data_ptr() for layer in self.cache['layers']
                        if isinstance(layer, dict) for t in layer.values()])
        return out


def test_the_kv_buffers_are_never_copied(setup, monkeypatch):
    """The save is shallow: every call reads and writes the KV buffers
    made at the start, and no Hyena state tensor that the loop saved
    changes under the verify pass after it."""
    model, _, tok = setup
    gamma, P = 4, len(REPETITIVE)
    stream, _ = _greedy(model, tok, REPETITIVE, 30)
    monkeypatch.setattr(spec.NGramIndex, 'propose',
                        _oracle(stream, P, [1, 4, 0, 2]))
    spy = _Spy(model)
    toks, _, stats = generate_speculative(spy, tok, prompt=REPETITIVE,
                                          num_tokens=25, gamma=gamma)
    np.testing.assert_array_equal(toks, stream[:25])
    assert len({tuple(p) for p in spy.kv}) == 1 and spy.kv[0]
    assert len(spy.saved) == stats.cycles
    for states in spy.saved:
        for state, values in states:
            for t, v in zip(state, values):
                assert torch.equal(t, v)


@pytest.mark.parametrize('gamma', [3, 8])
def test_greedy_int8_kv_matches_generator_and_jax(setup_int8, monkeypatch,
                                                  gamma):
    model, jmodel, tok = setup_int8
    n = 20
    stream, _ = _greedy(model, tok, ADVERSARIAL, n + gamma + 1)
    np.testing.assert_array_equal(generate_speculative(
        model, tok, prompt=ADVERSARIAL, num_tokens=n, gamma=gamma)[0],
        stream[:n])
    schedule = [gamma, 0, 2, gamma - 1]
    monkeypatch.setattr(spec.NGramIndex, 'propose',
                        _oracle(stream, len(ADVERSARIAL), schedule))
    got = generate_speculative(model, tok, prompt=ADVERSARIAL, num_tokens=n,
                               gamma=gamma)
    monkeypatch.setattr(jax_spec.NGramIndex, 'propose',
                        _oracle(stream, len(ADVERSARIAL), schedule))
    _same_run(got, jax_spec.generate_speculative(
        jmodel, tok, prompt=ADVERSARIAL, num_tokens=n, gamma=gamma))
    np.testing.assert_array_equal(got[0], stream[:n])


def test_max_len_and_input_ids(setup):
    """`max_len` sets the cache length (here an aligned one) and
    `input_ids` replaces the prompt; the tokens do not change."""
    model, _, tok = setup
    rec = _Recorder(model)
    ids = tok.tokenize(REPETITIVE)
    got = generate_speculative(rec, input_ids=ids, num_tokens=10, gamma=4,
                               max_len=128)
    assert rec.cache['layers'][1]['k'].shape[1] == 128
    want = generate_speculative(model, tok, prompt=REPETITIVE,
                                num_tokens=10, gamma=4)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize('gamma', [3, 8])
def test_oracle_drafter_runs_its_schedule(setup, monkeypatch, gamma):
    """`tools.spec_agreement.OracleDrafter`, the drafter `chip_smoke.py`
    phase 18 drives the accepting branches with: installed for one run
    and removed after it, it keeps the greedy stream and takes the
    accepted counts of its schedule cycle by cycle, as the JAX loop does
    from the same proposals."""
    from evo_tpu_torch.tools.spec_agreement import SCHEDULES, OracleDrafter
    model, jmodel, tok = setup
    n, schedule = 40, SCHEDULES[gamma]
    stream, _ = _greedy(model, tok, ADVERSARIAL, n + gamma + 1)
    drafter = OracleDrafter(model, tok, len(ADVERSARIAL), schedule)
    real = spec.NGramIndex.propose
    with drafter.installed():
        got = generate_speculative(model, tok, prompt=ADVERSARIAL,
                                   num_tokens=n, gamma=gamma)
    assert spec.NGramIndex.propose is real
    np.testing.assert_array_equal(got[0], stream[:n])
    cycles = got[2].cycles
    want = [min(schedule[c % len(schedule)], gamma) for c in range(cycles)]
    assert got[2].accepted == sum(want)
    assert drafter.anchors >= 1 and drafter.seconds > 0
    monkeypatch.setattr(jax_spec.NGramIndex, 'propose',
                        _oracle(stream, len(ADVERSARIAL), schedule))
    _same_run(got, jax_spec.generate_speculative(
        jmodel, tok, prompt=ADVERSARIAL, num_tokens=n, gamma=gamma))


# -- sampling -----------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('temp,k,p_nuc', [(1.0, 4, 1.0), (0.8, 0, 0.9)])
def test_seeded_sampled_stream_matches_jax(setup, seed, temp, k, p_nuc):
    """Both packages draw from np.random.default_rng(seed) on filtered
    distributions of logits ~1e-6 apart: the same tokens, decisions and
    stats. A mismatch here is reported as it is."""
    model, jmodel, tok = setup
    kw = dict(prompt=REPETITIVE, num_tokens=24, gamma=4, ngram=3,
              temperature=temp, top_k=k, top_p=p_nuc, seed=seed)
    got = generate_speculative(model, tok, **kw)
    _same_run(got, jax_spec.generate_speculative(jmodel, tok, **kw))
    again = generate_speculative(model, tok, **kw)
    np.testing.assert_array_equal(again[0], got[0])


@pytest.mark.parametrize('seed', [0, 1])
def test_sampled_acceptance_and_resampling_match_jax(setup, monkeypatch,
                                                     seed):
    """Sampling with proposals that are often accepted: the drafter
    proposes the greedy continuation of the stream so far (the port's
    Generator over it), which top-k = 2 accepts with the argmax's
    probability, at least 1/2, so a run takes accepted runs, residual
    draws and bonus tokens. Both packages take the same decisions from
    the same seed."""
    model, jmodel, tok = setup
    gamma = 4

    def propose(self, gamma):
        gen, _, _ = Generator(model, tok, top_k=1, temperature=0.0).generate(
            input_ids=np.asarray(self.tokens)[None], num_tokens=gamma)
        return gen[0].numpy().astype(np.int32)

    kw = dict(prompt=REPETITIVE, num_tokens=30, gamma=gamma,
              temperature=0.7, top_k=2, top_p=1.0, seed=seed)
    monkeypatch.setattr(spec.NGramIndex, 'propose', propose)
    monkeypatch.setattr(jax_spec.NGramIndex, 'propose', propose)
    got = generate_speculative(model, tok, **kw)
    _same_run(got, jax_spec.generate_speculative(jmodel, tok, **kw))
    stats = got[2]
    assert 0 < stats.accepted < stats.proposed


def test_validation_errors_are_the_jax_package(setup):
    model, jmodel, tok = setup
    for kw in (dict(prompt='', num_tokens=4),
               dict(prompt='ACGT', num_tokens=0),
               dict(prompt='ACGT', num_tokens=4, gamma=0)):
        with pytest.raises(ValueError) as ours:
            generate_speculative(model, tok, **kw)
        with pytest.raises(ValueError) as theirs:
            jax_spec.generate_speculative(jmodel, tok, **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match='pass input_ids= or prompt='):
        generate_speculative(model, None, prompt='ACGT')
    with pytest.raises(ValueError, match='pass input_ids= or prompt='):
        generate_speculative(model, tok)


def test_signature_follows_the_jax_package():
    import inspect
    ours = inspect.signature(generate_speculative).parameters
    theirs = inspect.signature(jax_spec.generate_speculative).parameters
    assert [(n, p.default) for n, p in ours.items()] == \
        [(n, p.default) for n, p in theirs.items()]


@pytest.mark.parametrize('fields', [
    {}, dict(hyena_fused_mixer=True), dict(hyena_pallas_prefix=True)],
    ids=['unfused', 'fused', 'prefix'])
def test_engine_state_is_replaced_not_written(setup, fields):
    """What the shallow save relies on, at the engine: resumed prefills
    of the lengths a verify pass and a replay take leave the HyenaState
    tensors they started from as they were, and put new ones in the
    cache."""
    model, _, tok = setup
    module = model.module
    cfg = model.config.replace(**fields)
    ids = torch.as_tensor(tok.tokenize(REPETITIVE))[None].long()
    module.config = cfg
    try:
        cache = model_lib.init_cache(cfg, 1, 64, 'cpu')
        _, cache = model_lib.prefill(module, ids, cache)
        for L in (5, 1, 2, 16, 9):
            before = list(cache['layers'])
            copies = [[t.clone() for t in s] for s in before
                      if isinstance(s, HyenaState)]
            _, cache = model_lib.prefill(module, ids[:, :L], cache,
                                         resume=True)
            states = [s for s in before if isinstance(s, HyenaState)]
            for s, c in zip(states, copies):
                for t, v in zip(s, c):
                    assert torch.equal(t, v), L
            assert all(a is not b for a, b in zip(before, cache['layers'])
                       if isinstance(a, HyenaState))
    finally:
        module.config = model.config
