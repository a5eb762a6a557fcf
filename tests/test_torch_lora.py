"""The port's LoRA (evo_tpu_torch/lora.py) against the JAX package's
(evo_tpu/lora.py), on the CPU in float32 at a small config: the same base
weights through the reference-named state dict, the same adapters through
`checkpoint.lora_from_jax`.

  * identity at init (bit for bit) and the attached forward against JAX's
    (rtol / atol 1e-4, the logit bounds of tests/test_golden.py);
  * the gradient of every adapter factor against jax.grad (scaled error
    <= 1e-4) and the adapters after 3 train steps against JAX's (the
    criterion of tests/test_torch_training.py);
  * merge_lora against the JAX package's merged logits (1e-4), not
    donated and donated;
  * adapter npz files written by either package read by the other, bit
    for bit, and a rank mismatch raising;
  * decode steps refuse attached adapters; a merged model generates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import lora as jax_lora
from evo_tpu import model as jax_model
from evo_tpu import training as jax_training
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu_torch import lora
from evo_tpu_torch import model as model_lib
from evo_tpu_torch import training
from evo_tpu_torch.checkpoint import (lora_from_jax, lora_to_jax,
                                      params_from_state_dict)
from evo_tpu_torch.config import tiny_config

torch.set_num_threads(2)
SMALL = dict(num_layers=3, hidden_size=32, num_attention_heads=2,
             attn_layer_idxs=(1,), hyena_layer_idxs=(0, 2),
             inner_mlp_size=48)
ALPHA = 8.0


@pytest.fixture(scope='module')
def setup():
    """JAX base weights and rank-4 adapters whose B factors are nonzero (a
    trained state's stand-in), and a batch."""
    jcfg = jax_tiny_config(**SMALL)
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)

    @jax.jit
    def make_adapters(params):
        adapters = jax_lora.init_lora(jax.random.PRNGKey(1), params, jcfg,
                                      rank=4)
        leaves, treedef = jax.tree_util.tree_flatten(adapters)
        keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, keys)])
    adapters = make_adapters(params)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    return jcfg, params, adapters, ids, mask


def port(jcfg, params, adapters=None):
    cfg = tiny_config(**SMALL)
    model = params_from_state_dict(jax_ckpt.export_state_dict(params, jcfg),
                                   cfg, 'cpu')
    return model, (None if adapters is None
                   else lora_from_jax(adapters, cfg, 'cpu'))


def forward(model, ids):
    return model_lib.forward(model, torch.as_tensor(ids).long()).numpy()


def assert_masters_close(got, want, peak):
    """As in tests/test_torch_training.py: every element within 6x the peak
    rate, 99.9 % of all within rtol 1e-5, atol 2e-6 (Adam's first updates
    are ~sign(g), so an element whose gradient is near eps can turn)."""
    close = []
    for name, m in got.items():
        err = np.abs(m.numpy() - want[name].numpy())
        assert err.max() <= 6 * peak, (name, err.max())
        close.append((err <= 2e-6 + 1e-5 * np.abs(want[name].numpy()))
                     .ravel())
    assert np.concatenate(close).mean() >= 0.999


def scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def test_identity_at_init(setup):
    jcfg, params, _, ids, _ = setup
    model, _ = port(jcfg, params)
    fresh = lora.init_lora(torch.Generator().manual_seed(3), model, rank=4)
    assert lora.lora_rank(fresh) == 4
    for name, t in lora.named_adapters(fresh).items():
        assert t.dtype == torch.float32
        if name.endswith('.b'):
            assert not t.any()
    base = forward(model, ids)
    lora.attach_lora(model, fresh, ALPHA)
    assert np.array_equal(forward(model, ids), base)
    lora.detach_lora(model)
    assert not lora.attached(model)


def test_attached_forward_matches_jax(setup):
    jcfg, params, adapters, ids, _ = setup
    want = jax_model.forward(jax_lora.attach_lora(params, adapters, ALPHA),
                             jcfg, jnp.asarray(ids))
    model, ad = port(jcfg, params, adapters)
    lora.attach_lora(model, ad, ALPHA)
    np.testing.assert_allclose(forward(model, ids), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_adapter_gradients_match_jax(setup):
    jcfg, params, adapters, ids, mask = setup
    cfg = tiny_config(**SMALL)
    jgrad = jax.jit(jax.grad(lambda a: jax_training.next_token_loss(
        jax_lora.attach_lora(params, a, ALPHA), jcfg, jnp.asarray(ids),
        jnp.asarray(mask))))(adapters)
    want = lora.named_adapters(lora_from_jax(jgrad, cfg, 'cpu'))
    model, ad = port(jcfg, params, adapters)
    named = lora.named_adapters(ad)
    training.set_trainable(named.values(), True)
    lora.attach_lora(model, ad, ALPHA)
    training.next_token_loss(model, None, ids, mask).backward()
    assert set(named) == set(want) and len(named) == 2 * (3 * 3 + 2 + 2 * 2)
    for name, t in named.items():
        assert scaled(t.grad.numpy(), want[name].numpy()) <= 1e-4, name
    assert all(p.grad is None for p in model.parameters())


def test_lora_train_steps_match_jax(setup):
    jcfg, params, adapters, ids, mask = setup
    cfg = tiny_config(**SMALL)
    jopt = jax_training.make_optimizer(learning_rate=1e-3)
    jstate = jax_lora.init_lora_train_state(adapters, jopt)
    jstep = jax.jit(jax_lora.make_lora_train_step(jcfg, jopt, alpha=ALPHA))
    model, ad = port(jcfg, params, adapters)
    opt = training.make_optimizer(learning_rate=1e-3)
    state = lora.init_lora_train_state(ad, opt)
    step = lora.make_lora_train_step(model, opt, alpha=ALPHA)
    base = forward(model, ids)
    for _ in range(3):
        jstate, jloss = jstep(jstate, params, jnp.asarray(ids),
                              jnp.asarray(mask))
        state, loss = step(state, ids, mask)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 3 and not lora.attached(model)
    assert np.array_equal(forward(model, ids), base)
    assert_masters_close(
        lora.named_adapters(state.lora),
        lora.named_adapters(lora_from_jax(jstate.lora, cfg, 'cpu')), 1e-3)


@pytest.mark.parametrize('donate', [False, True])
def test_merge_matches_jax(setup, donate):
    jcfg, params, adapters, ids, _ = setup
    want = jax_model.forward(jax_lora.merge_lora(params, adapters, ALPHA),
                             jcfg, jnp.asarray(ids))
    model, ad = port(jcfg, params, adapters)
    base = forward(model, ids)
    lora.attach_lora(model, ad, ALPHA)
    with pytest.raises(ValueError, match='detach_lora'):
        lora.merge_lora(model, ad, ALPHA)
    attached = forward(model, ids)
    lora.detach_lora(model)
    merged = lora.merge_lora(model, ad, ALPHA, donate=donate)
    assert (merged is model) == donate
    np.testing.assert_allclose(forward(merged, ids), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(forward(merged, ids), attached, rtol=1e-4,
                               atol=1e-4)
    if not donate:
        assert np.array_equal(forward(model, ids), base)
        assert merged.embedding is model.embedding
        assert merged.blocks[0].mlp.w1 is not model.blocks[0].mlp.w1


def test_npz_written_by_either_package(setup, tmp_path):
    jcfg, params, adapters, _, _ = setup
    cfg = tiny_config(**SMALL)
    model, ad = port(jcfg, params, adapters)
    template = lora.init_lora(torch.Generator().manual_seed(0), model,
                              rank=4)
    jax_path = str(tmp_path / 'jax.npz')
    jax_lora.save_lora(adapters, jax_path, alpha=12.0)
    got, alpha = lora.load_lora(jax_path, template)
    assert alpha == 12.0
    want = lora.named_adapters(ad)
    for name, t in lora.named_adapters(got).items():
        assert torch.equal(t, want[name]), name
    port_path = str(tmp_path / 'port.npz')
    lora.save_lora(ad, port_path, alpha=6.0)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert set(a.files) == set(b.files)
    back, alpha = jax_lora.load_lora(
        port_path, jax_lora.init_lora(jax.random.PRNGKey(0), params, jcfg,
                                      rank=4))
    assert alpha == 6.0
    for x, y in zip(jax.tree_util.tree_leaves(adapters),
                    jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    for (kp, x), (_, y) in zip(
            jax.tree_util.tree_flatten_with_path(adapters)[0],
            jax.tree_util.tree_flatten_with_path(lora_to_jax(ad))[0]):
        assert np.array_equal(np.asarray(x), y), jax.tree_util.keystr(kp)
    assert lora_from_jax(lora_to_jax(ad), cfg, 'cpu')[2]['hyena'].keys() == \
        {'w_in', 'w_out'}


def test_mismatches_raise(setup, tmp_path):
    jcfg, params, adapters, _, _ = setup
    model, ad = port(jcfg, params, adapters)
    path = str(tmp_path / 'a.npz')
    lora.save_lora(ad, path)
    rank8 = lora.init_lora(torch.Generator().manual_seed(0), model, rank=8)
    with pytest.raises(ValueError, match='rank/targets mismatch'):
        lora.load_lora(path, rank8)
    wrong = lora.init_lora(torch.Generator().manual_seed(0), model, rank=4)
    wrong[0]['mlp']['w1']['b'] = torch.zeros(4, 7)
    with pytest.raises(ValueError, match='rank/targets mismatch'):
        lora.attach_lora(model, wrong, ALPHA)
    with pytest.raises(ValueError, match='unknown LoRA targets'):
        lora.init_lora(torch.Generator(), model, targets=('w1', 'wz'))


def test_partial_targets(setup):
    jcfg, params, _, ids, _ = setup
    model, _ = port(jcfg, params)
    ad = lora.init_lora(torch.Generator().manual_seed(0), model, rank=2,
                        targets=('w1', 'wqkv'))
    names = set(lora.named_adapters(ad))
    assert names == {'blocks.0.mlp.w1.a', 'blocks.0.mlp.w1.b',
                     'blocks.1.attn.wqkv.a', 'blocks.1.attn.wqkv.b',
                     'blocks.1.mlp.w1.a', 'blocks.1.mlp.w1.b',
                     'blocks.2.mlp.w1.a', 'blocks.2.mlp.w1.b'}
    assert ad[0] == {'hyena': {}, 'mlp': ad[0]['mlp']}
    base = forward(model, ids)
    lora.attach_lora(model, ad)
    assert np.array_equal(forward(model, ids), base)


def test_decode_refuses_adapters_and_merged_model_generates(setup):
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    jcfg, params, adapters, _, _ = setup
    model, ad = port(jcfg, params, adapters)
    gen = Generator(EvoModel(model.config, model), CharLevelTokenizer(512),
                    top_k=1, temperature=0.0)
    lora.attach_lora(model, ad, ALPHA)
    with pytest.raises(RuntimeError, match='merge_lora'):
        gen.generate(input_ids=np.asarray([[65, 67, 71, 84]]), num_tokens=4)
    lora.detach_lora(model)
    lora.merge_lora(model, ad, ALPHA, donate=True)
    toks, _, _ = gen.generate(input_ids=np.asarray([[65, 67, 71, 84]]),
                              num_tokens=4)
    assert tuple(toks.shape) == (1, 4)


def test_quantized_base_is_not_ported(setup):
    from evo_tpu_torch.quant import quantize_params
    jcfg, params, adapters, _, _ = setup
    model, ad = port(jcfg, params, adapters)
    q = quantize_params(model, mode='int4')
    with pytest.raises(NotImplementedError, match='quantized base'):
        lora.init_lora(torch.Generator(), q)
    with pytest.raises(NotImplementedError, match='quantized base'):
        lora.attach_lora(q, ad)
    with pytest.raises(NotImplementedError, match='quantized base'):
        lora.make_lora_train_step(q, training.make_optimizer())
