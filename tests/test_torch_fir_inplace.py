"""The FIR + gate op reading the in-projection's output in place, and the
unfused Hyena layer around it, against the JAX package on the CPU at tiny
widths, inputs from numpy seeds.

The streams are the `(B, 3, C, L)` view `zl.permute(0, 2, 3, 1)` of a
`(B, L, 3, C)` buffer, as the layer passes them, with the in-projection
bias `b_in` folded into the op. On CPU tensors the wrapper takes its plain
version; the JAX side runs `fir_gate_pallas` in interpret mode and its
plain composition `fir_causal_conv` on `z + b_in`. The kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.layers import hyena as jax_hyena
from evo_tpu.ops import fftconv as jax_fftconv
from evo_tpu.ops.pallas_fir import fir_gate_pallas
from evo_tpu_torch import quant
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.layers import hyena
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.fir_gate import (check_kernel_args, fir_gate,
                                       fir_gate_plain, in_projection_layout)

torch.set_num_threads(2)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _both(a: np.ndarray, dtype: str):
    if dtype == 'bfloat16':
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, B, C, L, dtype, b_in, fir_b, tail):
    """(JAX, port) pairs: z as (B, 3, C, L) on the JAX side and as the
    permuted view of a (B, L, 3, C) buffer on the port's; taps; the two
    biases and the tail, or None."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return _both(rng.standard_normal(shape).astype(np.float32), dtype)

    zl_j, zl_t = draw(B, L, 3, C)
    z_j, z_t = jnp.transpose(zl_j, (0, 2, 3, 1)), zl_t.permute(0, 2, 3, 1)
    w = draw(3, C, 3)
    none = (None, None)
    return ((z_j, z_t), w, draw(3, C) if b_in else none,
            draw(3, C) if fir_b else none,
            draw(B, 3, C, 2) if tail else none)


# -- (a) the op on the in-place view ------------------------------------------

@pytest.mark.parametrize('tail', [False, True])
@pytest.mark.parametrize('fir_b', [False, True])
@pytest.mark.parametrize('b_in', [False, True])
@pytest.mark.parametrize('B,C,L', [(2, 8, 40), (1, 16, 77), (1, 8, 2)])
def test_fir_gate_on_the_in_projection_view(B, C, L, b_in, fir_b, tail):
    """float32: the plain version on the strided view against the Pallas
    kernel in interpret mode (fresh sequences; it takes no tail) and the
    JAX composition on `z + b_in`, 1e-5."""
    z, w, bi, fb, tl = _inputs(B * 100 + L, B, C, L, 'float32', b_in, fir_b,
                               tail)
    assert not z[1].is_contiguous() and in_projection_layout(z[1])
    x2, u = fir_gate(z[1], w[1], fb[1], tl[1], b_in=bi[1])
    assert x2.shape == u.shape == (B, C, L)
    zin = z[0] if bi[0] is None else z[0] + bi[0][None, :, :, None]
    zf, _ = jax_fftconv.fir_causal_conv(zin, w[0], fb[0], tl[0])
    wants = [(zf[:, 0], zf[:, 1] * zf[:, 2])]
    if not tail:
        wants.append(fir_gate_pallas(zin, w[0], fb[0], block_channels=8,
                                     interpret=True))
    for want_x2, want_u in wants:
        np.testing.assert_allclose(_np(x2), _np(want_x2), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(u), _np(want_u), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('tail', [False, True])
@pytest.mark.parametrize('b_in', [False, True])
def test_fir_gate_in_place_bf16_is_bit_equal(b_in, tail):
    """bf16: `zl + b_in` rounded once, each stream rounded before the
    gate: bit for bit the JAX composition."""
    z, w, bi, fb, tl = _inputs(7, 2, 16, 40, 'bfloat16', b_in, True, tail)
    x2, u = fir_gate(z[1], w[1], fb[1], tl[1], b_in=bi[1])
    zin = z[0] if bi[0] is None else z[0] + bi[0][None, :, :, None]
    zf, _ = jax_fftconv.fir_causal_conv(zin, w[0], fb[0], tl[0])
    np.testing.assert_array_equal(_np(x2), _np(zf[:, 0]))
    np.testing.assert_array_equal(_np(u), _np(zf[:, 1] * zf[:, 2]))


def test_fir_gate_in_place_equals_the_copy():
    """The view with `b_in` folded in gives what the contiguous biased
    copy the layer used to make gives, bit for bit."""
    z, w, bi, fb, tl = _inputs(3, 2, 8, 33, 'bfloat16', True, True, True)
    copy_z = (z[1] + bi[1][None, :, :, None]).contiguous()
    for got, want in zip(fir_gate(z[1], w[1], fb[1], tl[1], b_in=bi[1]),
                         fir_gate_plain(copy_z, w[1], fb[1], tl[1])):
        assert torch.equal(got, want)


# -- what the kernel takes, checked before any launch -------------------------

def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_kernel_takes_the_in_projection_view():
    for B, L in ((1, 1), (2, 1), (1, 64), (2, 77)):
        zl = _bf16(B, L, 3, 16)
        check_kernel_args(zl.permute(0, 2, 3, 1), _bf16(3, 16, 3),
                          _bf16(3, 16), _bf16(B, 3, 16, 2), _bf16(3, 16))


@pytest.mark.parametrize('what,make,match', [
    ('a contiguous (B, 3, C, L)',
     lambda: (_bf16(2, 3, 16, 40), _bf16(3, 16, 3)), 'in place'),
    ('C % 8',
     lambda: (_bf16(1, 40, 3, 12).permute(0, 2, 3, 1), _bf16(3, 12, 3)),
     'C % 8'),
    ('K != 3',
     lambda: (_bf16(1, 40, 3, 16).permute(0, 2, 3, 1), _bf16(3, 16, 4)),
     '3 taps'),
    ('a view that skips positions',
     lambda: (_bf16(1, 80, 3, 16)[:, ::2].permute(0, 2, 3, 1),
              _bf16(3, 16, 3)), 'in place'),
    ('a base off 16 bytes',
     lambda: (_bf16(1 + 3 * 16 * 40)[1:].view(1, 40, 3, 16)
              .permute(0, 2, 3, 1), _bf16(3, 16, 3)), 'in place'),
])
def test_kernel_refuses(what, make, match):
    z, w = make()
    with pytest.raises(ValueError, match=match):
        check_kernel_args(z, w, None, None, None)


def test_kernel_refuses_float32_and_mismatched_biases():
    zl = _bf16(1, 40, 3, 16)
    with pytest.raises(TypeError):
        check_kernel_args(zl.float().permute(0, 2, 3, 1),
                          _bf16(3, 16, 3).float(), None, None, None)
    with pytest.raises(ValueError, match='do not match'):
        check_kernel_args(zl.permute(0, 2, 3, 1), _bf16(3, 16, 3), None,
                          None, _bf16(3, 8))
    with pytest.raises(ValueError, match='one type'):
        check_kernel_args(zl.permute(0, 2, 3, 1), _bf16(3, 16, 3), None,
                          None, _bf16(3, 16).float())


# -- (b) the unfused layer against the JAX package ----------------------------

@pytest.fixture(scope='module')
def models():
    """(JAX Hyena params of layer 0, the port's, JAX config, port config),
    from one reference-named state dict with every tensor perturbed from
    the JAX init, so b_in and fir_b are not zeros."""
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
    jp = jax_model.layer_blocks(jparams, jcfg)[0]['hyena']
    tp = port.blocks[0].hyena
    assert tp.b_in is not None and float(tp.b_in.abs().max()) > 0
    return jp, tp, jcfg, port.config


def _parent_fir_state(p, x, K):
    """The FIR state as the layer computed it before it read zl in place:
    the last K-1 positions of the biased contiguous (B, 3, C, L) copy."""
    zl = quant.project(x, p.w_in, 1, p.act_quant)
    if p.b_in is not None:
        zl = zl + p.b_in
    z = zl.permute(0, 2, 3, 1).contiguous()
    return z[..., z.shape[-1] - (K - 1):].contiguous()


@pytest.mark.parametrize('lengths', [(40,), (24, 40), (33, 5, 3)])
def test_unfused_hyena_full_matches_jax(models, lengths):
    """Fresh, then resumed from the collected state: outputs within 1e-4
    of the JAX layer, the FIR state bit-equal to the parent's formula and
    within 1e-4 of the JAX one, the modal state within 1e-4."""
    jp, tp, jcfg, cfg = models
    rng = np.random.default_rng(sum(lengths))
    x = rng.standard_normal((2, sum(lengths), 64)).astype(np.float32)
    st_j = st_t = None
    s = 0
    for L in lengths:
        x_j, x_t = jnp.asarray(x[:, s:s + L]), torch.from_numpy(
            x[:, s:s + L])
        y_j, st_j = jax_hyena.hyena_full(jp, jcfg, x_j, collect_state=True,
                                         state=st_j)
        y_t, st_t = hyena.hyena_full(tp, cfg, x_t, collect_state=True,
                                     state=st_t)
        for got, want in ((y_t, y_j), (st_t.fir, st_j.fir),
                          (st_t.iir, st_j.iir)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-4)
        assert torch.equal(st_t.fir, _parent_fir_state(tp, x_t, 3))
        assert st_t.fir.is_contiguous() and st_t.fir.shape == (2, 3, 64, 2)
        s += L


def test_bf16_fir_state_is_the_parents(models):
    """In bf16, where the bias add rounds, the collected FIR state is bit
    for bit the tail of the biased copy the parent made, fresh and
    continued."""
    _, tp, _, cfg = models
    p = copy.deepcopy(tp)
    for name, prm in p.named_parameters():
        if name not in ('poles', 'residues'):
            prm.data = prm.data.bfloat16()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 50, 64)).astype(np.float32)).bfloat16()
    _, st = hyena.hyena_full(p, cfg, x[:, :30], collect_state=True)
    assert torch.equal(st.fir, _parent_fir_state(p, x[:, :30], 3))
    _, st = hyena.hyena_full(p, cfg, x[:, 30:], collect_state=True,
                             state=st)
    assert torch.equal(st.fir, _parent_fir_state(p, x[:, 30:], 3))


# -- (c) structure: no layout copy on the unfused path ------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The in-projection's outputs and the streams `fir_gate` and the fused
    mixer receive, with the calls still made."""
    seen = {'zl': [], 'fir_gate': [], 'hyena_mixer': []}

    def project(x, w, nc=1, act_quant=False):
        out = quant.project(x, w, nc, act_quant)
        if w.dim() == 3:                     # w_in (D, 3, C)
            seen['zl'].append(out)
        return out

    def recording(name, fn):
        def wrapper(z, *a, **kw):
            seen[name].append(z)
            return fn(z, *a, **kw)
        return wrapper

    monkeypatch.setattr(hyena, 'project', project)
    monkeypatch.setattr(hyena, 'fir_gate',
                        recording('fir_gate', hyena.fir_gate))
    monkeypatch.setattr(hyena, 'hyena_mixer',
                        recording('hyena_mixer', hyena.hyena_mixer))
    return seen


@pytest.mark.parametrize('carried', [False, True])
def test_unfused_path_reads_zl_in_place(models, recorded, carried):
    _, tp, _, cfg = models
    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(4))
    state = None
    if carried:
        _, state = hyena.hyena_full(tp, cfg, x[:, :16], collect_state=True)
    for k in recorded:
        recorded[k].clear()
    hyena.hyena_full(tp, cfg, x[:, 16:], collect_state=True, state=state)
    (zl,), (z,) = recorded['zl'], recorded['fir_gate']
    assert recorded['hyena_mixer'] == []
    assert zl.shape == (2, 32, 3, 64) and zl.is_contiguous()
    assert z.shape == (2, 3, 64, 32) and z.stride(2) == 1
    assert z.untyped_storage().data_ptr() == zl.untyped_storage().data_ptr()
    assert z.data_ptr() == zl.data_ptr() and in_projection_layout(z)


def _layout_ops(fn, B, L, C):
    """(bias adds over the (B, L, 3, C) buffer, copies into a (B, 3, C, L)
    tensor) that `fn` runs, from the profiler's record of shapes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as pr:
        fn()
    adds = copies = 0
    for e in pr.events():
        shapes = [list(s) for s in e.input_shapes if s]
        if e.name == 'aten::add' and shapes[:1] == [[B, L, 3, C]]:
            adds += 1
        if e.name == 'aten::copy_' and shapes[:1] == [[B, 3, C, L]]:
            copies += 1
    return adds, copies


def test_no_bias_pass_and_no_layout_copy(models):
    """The profiler sees neither the bias pass nor the (B, 3, C, L) copy
    on the unfused path, nor on the fused branch (its kernel reads the
    in-projection's output in place too)."""
    _, tp, _, cfg = models
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(5))
    assert _layout_ops(lambda: hyena.hyena_full(tp, cfg, x), 2, 32, 64) \
        == (0, 0)
    fused = cfg.replace(hyena_fused_mixer=True, hyena_matmul_chunk=16)
    assert _layout_ops(lambda: hyena.hyena_full(tp, fused, x), 2, 32, 64) \
        == (0, 0)


@pytest.mark.parametrize('L,calls', [(32, (1, 0)), (40, (0, 1)), (2, (0, 0))])
def test_fused_flag_keeps_its_branches(models, recorded, L, calls):
    """Under `hyena_fused_mixer` the fused mixer gets the in-place view
    of the in-projection's output where its shape rule holds; a ragged
    length falls through to the in-place FIR + gate, a length below the
    FIR width to `fir_causal_conv`; outputs agree with the unfused
    layer."""
    _, tp, _, cfg = models
    fused = cfg.replace(hyena_fused_mixer=True, hyena_matmul_chunk=16)
    x = torch.randn(2, L, 64, generator=torch.Generator().manual_seed(L))
    before = dict(_build.LAUNCHES)
    got, _ = hyena.hyena_full(tp, fused, x)
    assert dict(_build.LAUNCHES) == before      # CPU: plain versions
    assert (len(recorded['hyena_mixer']), len(recorded['fir_gate'])) == calls
    for z, zl in zip(recorded['hyena_mixer'], recorded['zl']):
        assert z.shape == (2, 3, 64, L) and in_projection_layout(z)
        assert z.data_ptr() == zl.data_ptr()
    want, _ = hyena.hyena_full(tp, cfg, x)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
