"""The fused Hyena mixer reading the in-projection's output in place, and
the fused branch of the Hyena layer around it, against the JAX package on
the CPU at tiny widths, inputs from numpy seeds.

The streams are the `(B, 3, C, L)` view `zl.permute(0, 2, 3, 1)` of a
`(B, L, 3, C)` buffer, as the layer passes them, with the in-projection
bias `b_in` folded into the op. On CPU tensors the wrapper takes its plain
version; the JAX side runs `hyena_mixer_pallas` in interpret mode on
`z + b_in`, as its own tests run it. The kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py.
"""

import copy
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.ops.pallas_hyena as jax_pallas_hyena
from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.layers import hyena as jax_hyena
from evo_tpu_torch import quant
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.layers import hyena
from evo_tpu_torch.ops.fir_gate import in_projection_layout
from evo_tpu_torch.ops.hyena_mixer import (hyena_mixer, hyena_mixer_plain,
                                           hyena_mixer_supported)

torch.set_num_threads(2)
# the JAX tests' own tolerance for the fused mixer against its unfused
# oracle, in float32
FUSED_TOL = dict(rtol=2e-4, atol=2e-4)
CHUNK = 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _inputs(seed, B, C, L, S, dtype, b_in, fir_b, carried):
    """(JAX arguments, port arguments, JAX state, port state, (JAX b_in,
    port b_in)). z is (B, 3, C, L) on the JAX side and the permuted view of
    a (B, L, 3, C) buffer on the port's; the parameters in `dtype` but the
    poles and residues, which stay float32."""
    rng = np.random.default_rng(seed)

    def both(a, dt=dtype):
        a = np.asarray(a, np.float32)
        if dt == 'bfloat16':
            return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
        return jnp.asarray(a), torch.from_numpy(a)

    zl_j, zl_t = both(rng.standard_normal((B, L, 3, C)))
    mag = rng.uniform(0.5, 0.98, (C, S))
    ang = rng.uniform(-np.pi, np.pi, (C, S))
    poles = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1)
    none = (None, None)
    arrays = [(jnp.transpose(zl_j, (0, 2, 3, 1)), zl_t.permute(0, 2, 3, 1)),
              both(rng.standard_normal((3, C, 3)) * 0.5),
              both(rng.standard_normal((3, C)) * 0.1) if fir_b else none,
              both(poles, np.float32),
              both(rng.standard_normal((C, S, 2)) * 0.3, np.float32),
              both(rng.standard_normal(C))]
    bias = both(rng.standard_normal((3, C)) * 0.3) if b_in else none
    st_j = st_t = None
    if carried:
        (f_j, f_t), (s_j, s_t) = (both(rng.standard_normal((B, 3, C, 2))),
                                  both(rng.standard_normal((B, C, S, 2)),
                                       np.float32))
        st_j, st_t = (f_j, s_j), (f_t, s_t)
    jargs, targs = zip(*arrays)
    return jargs, targs, st_j, st_t, bias


def _jax_mixer(jargs, st_j, b_in_j, chunk):
    z = jargs[0] if b_in_j is None else jargs[0] + b_in_j[None, :, :, None]
    return jax_pallas_hyena.hyena_mixer_pallas(
        z, *jargs[1:], chunk=chunk, state=st_j, interpret=True)


# -- (a) the op on the in-place view ------------------------------------------

@pytest.mark.parametrize('b_in,fir_b,carried',
                         list(itertools.product([False, True], repeat=3)))
def test_hyena_mixer_on_the_in_projection_view(b_in, fir_b, carried):
    B, C, L, S, chunk = 2, 8, 32, 4, 8
    jargs, targs, st_j, st_t, (bj, bt) = _inputs(
        4 * b_in + 2 * fir_b + carried, B, C, L, S, np.float32, b_in, fir_b,
        carried)
    assert in_projection_layout(targs[0])
    assert hyena_mixer_supported(targs[0].shape, chunk, S, 3)
    y_j, iir_j, fir_j = _jax_mixer(jargs, st_j, bj, chunk)
    y, iir, fir = hyena_mixer_plain(*targs, chunk=chunk, state=st_t,
                                    b_in=bt)
    assert y.shape == (B, C, L) and iir.shape == (B, C, S, 2)
    assert fir.shape == (B, 3, C, 2) and iir.dtype == torch.float32
    _close(y, y_j, **FUSED_TOL)
    _close(iir, iir_j, **FUSED_TOL)
    _close(fir, fir_j, rtol=1e-6, atol=1e-6)
    # a CPU tensor takes the plain version
    got = hyena_mixer(*targs, chunk=chunk, state=st_t, b_in=bt)
    for a, b in zip(got, (y, iir, fir)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('carried', [False, True])
def test_hyena_mixer_in_place_bf16(carried):
    """bf16 streams with b_in: the bias add rounds once, as the JAX
    package's `z + b_in`; y and the state agree to bf16 noise (the JAX
    test's 3e-2), the FIR tail bit for bit."""
    jargs, targs, st_j, st_t, (bj, bt) = _inputs(
        11 + carried, 1, 16, 64, 4, 'bfloat16', True, True, carried)
    y_j, iir_j, fir_j = _jax_mixer(jargs, st_j, bj, 16)
    y, iir, fir = hyena_mixer_plain(*targs, chunk=16, state=st_t, b_in=bt)
    assert y.dtype == torch.bfloat16 and fir.dtype == torch.bfloat16
    _close(y, y_j, rtol=3e-2, atol=3e-2)
    _close(iir, iir_j, rtol=3e-2, atol=3e-2)
    _close(fir, fir_j, rtol=0, atol=0)


def test_hyena_mixer_in_place_segments_continue():
    """Two halves of the in-place view with the carried state equal one
    pass; the second half against the JAX kernel seeded the same way."""
    B, C, L, S, chunk = 1, 8, 64, 4, 8
    jargs, targs, _, _, (bj, bt) = _inputs(21, B, C, L, S, np.float32, True,
                                           True, False)
    y, iir, fir = hyena_mixer_plain(*targs, chunk=chunk, b_in=bt)
    h = L // 2
    z = targs[0]
    y1, iir1, fir1 = hyena_mixer_plain(z[..., :h], *targs[1:], chunk=chunk,
                                       b_in=bt)
    y2, iir2, fir2 = hyena_mixer_plain(z[..., h:], *targs[1:], chunk=chunk,
                                       state=(fir1, iir1), b_in=bt)
    _close(torch.cat([y1, y2], -1), y, **FUSED_TOL)
    _close(iir2, iir, **FUSED_TOL)
    assert torch.equal(fir2, fir)
    y2_j, iir2_j, fir2_j = _jax_mixer(
        (jargs[0][..., h:], *jargs[1:]),
        (jnp.asarray(fir1.numpy()), jnp.asarray(iir1.numpy())), bj, chunk)
    _close(y2, y2_j, **FUSED_TOL)
    _close(iir2, iir2_j, **FUSED_TOL)
    _close(fir2, fir2_j, rtol=1e-6, atol=1e-6)


# -- (b) the fused layer against the JAX package ------------------------------

@pytest.fixture(scope='module')
def models():
    """(JAX Hyena params of layer 0, the port's, JAX config, port config),
    both with the fused mixer and a chunk of 16, from one reference-named
    state dict with every tensor perturbed from the JAX init, so b_in and
    fir_b are not zeros."""
    jcfg = jax_tiny_config(hyena_matmul_chunk=CHUNK).replace(
        hyena_fused_mixer=True, use_pallas='always')
    sd = jax_ckpt.export_state_dict(
        jax_model.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
        include_buffers=False)
    rng = np.random.default_rng(0)
    for k, a in sd.items():
        if not k.endswith('poles'):
            sd[k] = (a + 0.05 * rng.standard_normal(a.shape)).astype(
                a.dtype)
    jparams = jax_ckpt.convert_state_dict(dict(sd), jcfg)
    cfg = tiny_config(hyena_matmul_chunk=CHUNK, hyena_fused_mixer=True)
    port = params_from_state_dict(sd, cfg, 'cpu')
    jp = jax_model.layer_blocks(jparams, jcfg)[0]['hyena']
    tp = port.blocks[0].hyena
    assert tp.b_in is not None and float(tp.b_in.abs().max()) > 0
    assert tp.fir_b is not None
    return jp, tp, jcfg, port.config


@pytest.fixture
def interpret_mixer(monkeypatch):
    monkeypatch.setattr(jax_pallas_hyena, 'hyena_mixer_pallas',
                        functools.partial(jax_pallas_hyena.hyena_mixer_pallas,
                                          interpret=True))


def _parent_fir_state(p, x, K):
    """The FIR state as the parent computed it: the last K-1 positions of
    the biased contiguous (B, 3, C, L) copy of the in-projection's
    output."""
    zl = quant.project(x, p.w_in, 1, p.act_quant)
    if p.b_in is not None:
        zl = zl + p.b_in
    z = zl.permute(0, 2, 3, 1).contiguous()
    return z[..., z.shape[-1] - (K - 1):].contiguous()


@pytest.mark.parametrize('lengths', [(32,), (16, 48), (64, 16, 32)])
def test_fused_hyena_full_matches_jax(models, interpret_mixer, lengths):
    """Fresh, then resumed from the collected state, every segment a
    multiple of the chunk (the fused branch in both packages): outputs
    within 1e-4 of the JAX layer with its kernel in interpret mode, the
    FIR state bit-equal to the parent's and within 1e-4 of the JAX one,
    the modal state within 1e-4."""
    jp, tp, jcfg, cfg = models
    rng = np.random.default_rng(sum(lengths))
    x = rng.standard_normal((2, sum(lengths), 64)).astype(np.float32)
    st_j = st_t = None
    s = 0
    for L in lengths:
        assert hyena_mixer_supported((2, 3, 64, L), CHUNK, 4, 3)
        x_j, x_t = jnp.asarray(x[:, s:s + L]), torch.from_numpy(
            x[:, s:s + L])
        y_j, st_j = jax_hyena.hyena_full(jp, jcfg, x_j, collect_state=True,
                                         state=st_j)
        y_t, st_t = hyena.hyena_full(tp, cfg, x_t, collect_state=True,
                                     state=st_t)
        for got, want in ((y_t, y_j), (st_t.fir, st_j.fir),
                          (st_t.iir, st_j.iir)):
            _close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(st_t.fir, _parent_fir_state(tp, x_t, 3))
        assert st_t.fir.is_contiguous() and st_t.fir.shape == (2, 3, 64, 2)
        s += L


def test_bf16_fused_fir_state_is_the_parents(models):
    """In bf16, where the bias add rounds, the fused branch's FIR state is
    bit for bit the tail of the biased copy the parent made, fresh and
    continued."""
    _, tp, _, cfg = models
    p = copy.deepcopy(tp)
    for name, prm in p.named_parameters():
        if name not in ('poles', 'residues'):
            prm.data = prm.data.bfloat16()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 80, 64)).astype(np.float32)).bfloat16()
    _, st = hyena.hyena_full(p, cfg, x[:, :32], collect_state=True)
    assert torch.equal(st.fir, _parent_fir_state(p, x[:, :32], 3))
    _, st = hyena.hyena_full(p, cfg, x[:, 32:], collect_state=True,
                             state=st)
    assert torch.equal(st.fir, _parent_fir_state(p, x[:, 32:], 3))


# -- (c) structure: the fused mixer reads zl in place --------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The in-projection's outputs and the streams the fused mixer
    receives, with the calls still made."""
    seen = {'zl': [], 'hyena_mixer': []}

    def project(x, w, nc=1, act_quant=False):
        out = quant.project(x, w, nc, act_quant)
        if w.dim() == 3:                     # w_in (D, 3, C)
            seen['zl'].append(out)
        return out

    def mixer(z, *a, **kw):
        seen['hyena_mixer'].append((z, kw))
        return hyena_mixer(z, *a, **kw)

    monkeypatch.setattr(hyena, 'project', project)
    monkeypatch.setattr(hyena, 'hyena_mixer', mixer)
    return seen


@pytest.mark.parametrize('carried', [False, True])
def test_fused_branch_reads_zl_in_place(models, recorded, carried):
    _, tp, _, cfg = models
    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(4))
    state = None
    if carried:
        _, state = hyena.hyena_full(tp, cfg, x[:, :16], collect_state=True)
    for k in recorded:
        recorded[k].clear()
    hyena.hyena_full(tp, cfg, x[:, 16:], collect_state=True, state=state)
    (zl,), ((z, kw),) = recorded['zl'], recorded['hyena_mixer']
    assert zl.shape == (2, 32, 3, 64) and zl.is_contiguous()
    assert z.shape == (2, 3, 64, 32) and in_projection_layout(z)
    assert z.untyped_storage().data_ptr() == zl.untyped_storage().data_ptr()
    assert z.data_ptr() == zl.data_ptr()
    assert kw['b_in'] is tp.b_in


# -- (d) the support rule against the JAX package's ----------------------------

@pytest.mark.parametrize('C', [1, 4, 5, 8, 12, 16, 24, 40, 4096, 4100])
def test_support_rule_matches_jax(C):
    """Where the port's kernel takes S <= 8 states and 3 taps, its rule is
    the JAX kernel's (`_pick_blocks`: C a multiple of 8 and the chunk
    dividing L), up to the port's chunk of at most 64."""
    for B, L, chunk in itertools.product(
            (1, 3), (1, 3, 7, 37, 48, 64, 100, 128, 192, 8192),
            (1, 8, 16, 21, 64)):
        shape = (B, 3, C, L)
        want = jax_pallas_hyena.hyena_mixer_supported(shape, chunk)
        assert hyena_mixer_supported(shape, chunk, 8, 3) is want, (shape,
                                                                   chunk)
        assert hyena_mixer_supported(shape, chunk, 4, 3) is want
    assert not hyena_mixer_supported((1, 3, C, 256), 128, 8, 3)
