"""The PyTorch port as a whole against the JAX package, on the CPU in
float32 at the tiny config, on the weights of
`evo_tpu.model.init_params(PRNGKey(0), tiny_config())` carried across by
the reference-named state dict:

  * scoring reproduces tests/golden/tiny_scores.npz (scores rtol 1e-5,
    logits rtol/atol 1e-4, the bounds of tests/test_golden.py);
  * greedy generation is token-exact against tests/golden/tiny_greedy.npz;
  * prefill + decode logits match the JAX prefill / decode_step at 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.io.fasta import read_fasta
from evo_tpu.ops import sampling as jax_sampling
from evo_tpu_torch import model as model_lib
from evo_tpu_torch.checkpoint import params_from_state_dict, state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.generation import Generator, generate
from evo_tpu_torch.models import Evo, EvoModel
from evo_tpu_torch.ops import sampling
from evo_tpu_torch.scoring import positional_entropies, score_sequences
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, 'golden')


@pytest.fixture(scope='module')
def setup():
    jcfg = jax_tiny_config()
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    sd = jax_ckpt.export_state_dict(params, jcfg)
    model = EvoModel(tiny_config(),
                     params_from_state_dict(sd, tiny_config(), 'cpu'))
    return model, CharLevelTokenizer(512), params, jcfg


def _seqs():
    return read_fasta(os.path.join(HERE, '..', 'examples',
                                   'example_seqs.fasta'))[1]


def test_scores_match_golden(setup):
    model, tok, _, _ = setup
    seqs = _seqs()
    want = np.load(os.path.join(GOLDEN, 'tiny_scores.npz'))
    scores = np.asarray(score_sequences(seqs, model, tok), np.float64)
    np.testing.assert_allclose(scores, want['scores'], rtol=1e-5, atol=1e-6)
    logits, cache = model(tok.tokenize(seqs[0])[None])
    assert cache is None
    assert model.num_params == jax_model.param_count(setup[2])
    np.testing.assert_allclose(logits.numpy(), want['logits0'], rtol=1e-4,
                               atol=1e-4)


def test_greedy_generation_matches_golden(setup):
    model, tok, _, _ = setup
    want = np.load(os.path.join(GOLDEN, 'tiny_greedy.npz'))
    seqs, scores = generate(['ACGTACGT'], model, tok, n_tokens=16, top_k=1,
                            temperature=1.0, verbose=0)
    assert seqs[0] == bytes(want['seq']).decode()
    np.testing.assert_allclose(scores[0], float(want['score']), rtol=1e-5)


def test_prefill_decode_match_jax(setup):
    model, _, params, jcfg = setup
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 11)).astype(np.int32)
    steps = rng.integers(0, 512, (3, 2)).astype(np.int32)
    jcache = jax_model.init_cache(jcfg, 2, 16)
    want, jcache = jax_model.prefill(params, jcfg, jnp.asarray(ids), jcache)
    cache = model.initialize_inference_params(2, 16)
    got, cache = model(ids, inference_params_dict=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert cache['offset'] == 11
    for tok in steps:
        want, jcache = jax_model.decode_step(params, jcfg, jnp.asarray(tok),
                                             jcache)
        got, cache = model(tok[:, None], inference_params_dict=cache)
        assert got.shape == (2, 1, 512)
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    assert cache['offset'] == 14


def test_positional_entropies_match_jax_forward(setup):
    model, tok, params, jcfg = setup
    seqs = ['ACGTTGCA', 'ACG']
    got = positional_entropies(seqs, model, tok)
    ids = np.array([[0] + list(b'ACGTTGCA'), [0] + list(b'ACG') + [1] * 5],
                   np.int32)
    logp = jax.nn.log_softmax(jax_model.forward(params, jcfg,
                                                jnp.asarray(ids)), -1)
    ent = np.asarray(-jnp.sum(jnp.exp(logp) * logp, -1))[:, :-1]
    for g, e, s in zip(got, ent, seqs):
        np.testing.assert_allclose(g, e[:len(s)], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_weight_bridge_round_trip(dtype):
    jcfg = jax_tiny_config(param_dtype=dtype, compute_dtype=dtype)
    sd = jax_ckpt.export_state_dict(
        jax_model.init_params(jax.random.PRNGKey(1), jcfg), jcfg)
    model = params_from_state_dict(
        sd, tiny_config(param_dtype=dtype, compute_dtype=dtype), 'cpu')
    back = state_dict(model)
    buffers = {k for k in sd if k.endswith('inv_freq')}
    assert buffers and set(back) == set(sd) - buffers
    for k, t in back.items():
        a = np.asarray(sd[k])
        assert tuple(t.shape) == a.shape, k
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=k)


def test_sampling_filters_match_jax():
    logits = np.random.default_rng(2).standard_normal((3, 512)).astype(
        np.float32)
    lj, lt = jnp.asarray(logits), torch.from_numpy(logits)
    for k in (0, 1, 5, 600):
        np.testing.assert_array_equal(sampling.top_k_filter(lt, k).numpy(),
                                      np.asarray(jax_sampling.top_k_filter(
                                          lj, k)))
    for p in (0.0, 0.3, 0.9, 1.0):
        np.testing.assert_array_equal(sampling.top_p_filter(lt, p).numpy(),
                                      np.asarray(jax_sampling.top_p_filter(
                                          lj, p)))
    np.testing.assert_array_equal(
        sampling.sample(lt, top_k=1).numpy(),
        np.asarray(jax_sampling.sample(jax.random.PRNGKey(0), lj, top_k=1)))


def test_sampled_generation_is_seeded(setup):
    model, tok, _, _ = setup
    g = Generator(model, tok, top_k=4, top_p=0.9, temperature=1.0)
    a, scores, _ = g.generate('ACGT', num_tokens=6, seed=3)
    b, _, _ = g.generate('ACGT', num_tokens=6, seed=3)
    assert torch.equal(a, b) and a.shape == (1, 6)
    assert scores.shape == (1, 6, 512)


def test_forced_prompt_matches_full_prefill(setup):
    """Teacher forcing feeds the prompt tail through decode steps; greedy
    output equals prefilling the whole prompt."""
    model, tok, _, _ = setup
    g = Generator(model, tok, top_k=1)
    a, sa, _ = g.generate('ACGTACGTAC', num_tokens=5)
    b, sb, _ = g.generate('ACGTACGTAC', num_tokens=5,
                          force_prompt_threshold=4)
    assert torch.equal(a, b)
    np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_unported_paths_raise(setup):
    """What the port does not hold yet raises and names its ROADMAP item
    (weights kept in another type than the activations); what it now
    holds (a filled cache continued, segments, the int8 KV cache,
    quantized weights, weights from a file, speculative decoding, serving
    under a mesh, LoRA training under cp) no longer does."""
    model, tok, _, _ = setup
    cache = model.initialize_inference_params(1, 32)
    model(np.zeros((1, 4), np.int32), inference_params_dict=cache)
    _, cache = model(np.zeros((1, 4), np.int32), inference_params_dict=cache)
    assert cache['offset'] == 8
    assert tiny_config(kv_quant='int8').kv_quant == 'int8'
    for quant in ('int8', 'int4'):
        assert tiny_config(weight_quant=quant).weight_quant == quant
    assert tiny_config(weight_quant='int8', act_quant='int8').act_quant \
        == 'int8'
    # cp > 1 is ported (tests/test_torch_context_parallel.py), serving
    # under a mesh (tests/test_torch_mesh_serving.py) and training under
    # cp (tests/test_torch_cp_training.py): the LoRA step builds on a cp
    # mesh
    from evo_tpu_torch import lora, training
    from evo_tpu_torch.parallel.mesh import Mesh
    model.module.mesh = Mesh(1, 2, 1)
    try:
        assert callable(lora.make_lora_train_step(
            model, training.make_optimizer()))
    finally:
        model.module.mesh = None
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tiny_config(param_dtype='float32', compute_dtype='bfloat16')
    from evo_tpu_torch.cli import generate as generate_cli
    seqs, scores = generate_cli.main(['--tiny', '--device', 'cpu', '--prompt',
                                      'ACGT', '--n-samples', '1',
                                      '--n-tokens', '6', '--speculative', '4',
                                      '--verbose', '0'])
    assert len(seqs) == 1 and len(seqs[0]) == 6 and np.isfinite(scores[0])
    for field in ('weight_quant', 'act_quant', 'kv_quant'):
        with pytest.raises(ValueError, match=field):
            tiny_config(**{field: 'int2'})


def test_random_init_distributions():
    cfg = tiny_config(hidden_size=128, num_filters=128, state_size=8)
    m = model_lib.random_init(cfg, torch.Generator().manual_seed(0), 'cpu')
    mag = torch.linalg.vector_norm(m.blocks[0].hyena.poles, dim=-1)
    assert 0.6 <= float(mag.min()) and float(mag.max()) <= 0.99
    assert abs(float(m.embedding.std()) - 0.02) < 2e-3
    assert abs(float(m.blocks[0].mlp.w1.std()) - 128 ** -0.5) < 1e-2
    assert torch.equal(m.blocks[1].attn.bqkv,
                       torch.zeros_like(m.blocks[1].attn.bqkv))
