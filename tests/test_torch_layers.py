"""The PyTorch port's layers and plain ops against their JAX counterparts,
in float32 on the CPU at tiny size (tolerance 1e-5 unless stated).

Weights come from one reference-named state dict with every tensor
perturbed from the JAX init (so biases and norm scales are not trivially
0 and 1), read by both packages' loaders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.layers import attention as jax_attn
from evo_tpu.layers import hyena as jax_hyena
from evo_tpu.layers import mlp as jax_mlp
from evo_tpu.layers import rotary as jax_rotary
from evo_tpu.ops import fftconv as jax_fftconv
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.layers import attention, hyena, rotary
from evo_tpu_torch.ops import fftconv

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope='module')
def models():
    """(JAX per-layer params, port model, JAX config, port config)."""
    jcfg = jax_tiny_config()
    sd = jax_ckpt.export_state_dict(
        jax_model.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
        include_buffers=False)
    rng = np.random.default_rng(0)
    for k, a in sd.items():
        if not k.endswith('poles'):
            sd[k] = (a + 0.05 * rng.standard_normal(a.shape)).astype(
                a.dtype)
    jparams = jax_ckpt.convert_state_dict(dict(sd), jcfg)
    port = params_from_state_dict(sd, tiny_config(), 'cpu')
    return jax_model.layer_blocks(jparams, jcfg), port, jcfg, port.config


def _rand(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# -- ops/fftconv ---------------------------------------------------------------

def _poles(rng, D, S):
    mag = rng.uniform(0.6, 0.99, (D, S))
    ang = rng.uniform(-np.pi, np.pi, (D, S))
    return np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1).astype(
        np.float32)


@pytest.mark.parametrize('L,chunk,skip,with_state', [
    (64, 16, True, False),
    (64, 16, False, False),
    (50, 16, True, False),     # L not a multiple of the chunk
    (48, 16, True, True),      # carried state (chunk | L)
    (5, 16, False, False),     # one short chunk
])
def test_conv_matmul_chunked(L, chunk, skip, with_state):
    rng = np.random.default_rng(1)
    B, D, S = 2, 8, 4
    u_j, u_t = _rand(rng, B, D, L)
    poles = _poles(rng, D, S)
    res = (rng.standard_normal((D, S, 2)) / S).astype(np.float32)
    d_j, d_t = _rand(rng, D) if skip else (None, None)
    s_j, s_t = _rand(rng, B, D, S, 2) if with_state else (None, None)
    y_j, st_j = jax_fftconv.conv_matmul_chunked(
        u_j, jnp.asarray(poles), jnp.asarray(res), chunk, state=s_j,
        d_skip=d_j)
    y_t, st_t = fftconv.conv_matmul_chunked(
        u_t, torch.from_numpy(poles), torch.from_numpy(res), chunk,
        state=s_t, d_skip=d_t)
    _close(y_t, y_j)
    _close(st_t, st_j)


def test_fir_causal_conv_with_state_and_fir_step():
    rng = np.random.default_rng(2)
    z_j, z_t = _rand(rng, 2, 3, 8, 11)
    w_j, w_t = _rand(rng, 3, 8, 3)
    b_j, b_t = _rand(rng, 3, 8)
    s_j, s_t = _rand(rng, 2, 3, 8, 2)
    y_j, ns_j = jax_fftconv.fir_causal_conv(z_j, w_j, b_j, s_j)
    y_t, ns_t = fftconv.fir_causal_conv(z_t, w_t, b_t, s_t)
    _close(y_t, y_j)
    _close(ns_t, ns_j)
    y_j, ns_j = jax_fftconv.fir_step(z_j[..., 0], w_j, b_j, s_j)
    y_t, ns_t = fftconv.fir_step(z_t[..., 0], w_t, b_t, s_t)
    _close(y_t, y_j)
    _close(ns_t, ns_j)


def test_modal_step():
    rng = np.random.default_rng(3)
    D, S = 8, 4
    poles = _poles(rng, D, S)
    u_j, u_t = _rand(rng, 2, D)
    r_j, r_t = _rand(rng, D, S, 2)
    d_j, d_t = _rand(rng, D)
    s_j, s_t = _rand(rng, 2, D, S, 2)
    y_j, ns_j = jax_fftconv.modal_step(u_j, jnp.asarray(poles), r_j, d_j,
                                       s_j)
    y_t, ns_t = fftconv.modal_step(u_t, torch.from_numpy(poles), r_t, d_t,
                                   s_t)
    _close(y_t, y_j)
    _close(ns_t, ns_j)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize('scaling', [1.0, 16.0])
def test_rotary(scaling):
    rng = np.random.default_rng(4)
    x_j, x_t = _rand(rng, 2, 9, 2, 16)
    pos = np.arange(5, 14)
    cj, sj = jax_rotary.rotary_cos_sin(jnp.asarray(pos), 16, 10000.0,
                                       scaling)
    ct, st = rotary.rotary_cos_sin(torch.from_numpy(pos), 16, 10000.0,
                                   scaling)
    _close(ct, cj)
    _close(st, sj)
    _close(rotary.apply_rotary(x_t, ct, st),
           jax_rotary.apply_rotary(x_j, cj, sj))


def test_gated_mlp(models):
    jblocks, port, _, _ = models
    x_j, x_t = _rand(np.random.default_rng(5), 2, 7, 64)
    _close(port.blocks[0].mlp(x_t),
           jax_mlp.gated_mlp(jblocks[0]['mlp'], x_j, 'gelu'))


@pytest.mark.parametrize('L', [2, 100])     # below the FIR width; padded
def test_hyena_full_and_step(models, L):
    jblocks, port, jcfg, cfg = models
    rng = np.random.default_rng(6)
    jp, tp = jblocks[0]['hyena'], port.blocks[0].hyena
    x_j, x_t = _rand(rng, 2, L, 64)
    y_j, st_j = jax_hyena.hyena_full(jp, jcfg, x_j, collect_state=True)
    y_t, st_t = hyena.hyena_full(tp, cfg, x_t, collect_state=True)
    _close(y_t, y_j)
    _close(st_t.fir, st_j.fir)
    _close(st_t.iir, st_j.iir)
    xs_j, xs_t = _rand(rng, 2, 1, 64)
    y_j, st_j = jax_hyena.hyena_step(jp, jcfg, xs_j, st_j)
    y_t, st_t = hyena.hyena_step(tp, cfg, xs_t, st_t)
    _close(y_t, y_j)
    _close(st_t.fir, st_j.fir)
    _close(st_t.iir, st_j.iir)


def test_mha_full_with_kv_buffers_and_step(models):
    jblocks, port, jcfg, cfg = models
    rng = np.random.default_rng(7)
    jp, tp = jblocks[1]['attn'], port.blocks[1].attn
    B, L, T = 2, 9, 16
    x_j, x_t = _rand(rng, B, L, 64)
    zeros = np.zeros((B, T, 4, 16), np.float32)
    kv_j = {'k': jnp.asarray(zeros), 'v': jnp.asarray(zeros)}
    kv_t = {'k': torch.zeros(B, T, 4, 16), 'v': torch.zeros(B, T, 4, 16)}
    y_j, kv_j = jax_attn.mha_full(jp, jcfg, x_j, kv_buffers=kv_j)
    y_t, kv_t = attention.mha_full(tp, cfg, x_t, kv_buffers=kv_t)
    _close(y_t, y_j)
    _close(kv_t['k'], kv_j['k'])
    _close(kv_t['v'], kv_j['v'])
    for offset in (L, L + 1):
        xs_j, xs_t = _rand(rng, B, 1, 64)
        y_j, kv_j = jax_attn.mha_step(jp, jcfg, xs_j, kv_j, offset)
        y_t, kv_t = attention.mha_step(tp, cfg, xs_t, kv_t, offset)
        _close(y_t, y_j)
        _close(kv_t['k'], kv_j['k'])
