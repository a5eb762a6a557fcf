"""The PyTorch port's CUDA kernels against their plain versions, on the
card. Without a CUDA device every test here skips.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has neither (tests/conftest.py imports JAX; skip it):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -q
"""

import pytest
import torch

from evo_tpu_torch.layers.attention import kv_quantize
from evo_tpu_torch.ops.attention import (attention_plain,
                                         flash_attention_causal)
from evo_tpu_torch.ops.attention_buffer import (attention_buffer_plain,
                                                flash_attention_buffer)
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.fir_gate import fir_gate, fir_gate_plain
from evo_tpu_torch.ops.int4 import (int4_matmul, int4_matmul_plain,
                                    pack_int4)
from evo_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

torch.set_num_threads(2)

# A string condition is evaluated when each test is set up, not while the
# module is imported, so every xdist worker collects the same tests.
pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif('not torch.cuda.is_available()',
                       reason='needs a CUDA device: the kernels build and '
                              'run only on the card'),
]


@pytest.fixture
def randn():
    g = torch.Generator(device='cuda').manual_seed(0)
    return lambda *shape: torch.randn(*shape, device='cuda',
                                      generator=g).bfloat16()


@pytest.mark.parametrize('rows', [1, 4, 8192])
def test_rmsnorm_kernel(randn, rows):
    x, w = randn(rows, 4096), randn(4096)
    got, want = rmsnorm(x, w).float(), rmsnorm_plain(x, w).float()
    torch.cuda.synchronize()
    # one bf16 rounding step apart at most (2^-7 relative), as the fp32 row
    # sums are taken in another order
    assert ((got - want).abs() / want.abs().clamp(min=1)).max() <= 1e-2


@pytest.mark.parametrize('B,L', [(1, 1), (1, 3), (2, 77), (1, 1000)])
@pytest.mark.parametrize('bias', [True, False])
def test_fir_gate_kernel(randn, B, L, bias):
    z, w = randn(B, 3, 4096, L), randn(3, 4096, 3)
    b = randn(3, 4096) if bias else None
    for got, want in zip(fir_gate(z, w, b), fir_gate_plain(z, w, b)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _scaled_err(got, want):
    """Largest |err| over the larger of |want| and the rms of its
    (position, head) row. Attention outputs shrink along the sequence, so
    no one absolute limit holds the late rows. Output rounding gives at
    most one bf16 step (2^-7) of that, the kernels' bf16 P a few 2^-9; the
    limit is four bf16 steps, 2^-5."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got - want).abs() / want.abs().maximum(rms)).max()


@pytest.mark.parametrize('B,L', [(1, 1), (1, 63), (1, 64), (2, 1000)])
def test_flash_attention_kernel(randn, B, L):
    qkv = randn(B, L, 3, 32, 128)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == q.shape
    assert _scaled_err(got, attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.parametrize('B,L', [(1, 1), (1, 2), (2, 77), (1, 1000)])
def test_fir_gate_kernel_with_carried_tail(randn, B, L):
    z, w, b = randn(B, 3, 4096, L), randn(3, 4096, 3), randn(3, 4096)
    tail = randn(B, 3, 4096, 2)
    for got, want in zip(fir_gate(z, w, b, tail),
                         fir_gate_plain(z, w, b, tail)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize('B,Lq,T,offset', [
    (1, 128, 1024, 0),           # fresh, into a longer buffer
    (1, 128, 1024, 731),         # an unaligned offset
    (1, 100, 1024, 512),         # Lq not a multiple of the query tile
    (1, 256, 2048, 1792),        # the segment fills the buffer to the brim
    (2, 64, 1000, (100, 900)),   # per-row offsets, T not a multiple of 128
    (2, 1, 777, (5, 776)),       # one query row (decode)
])
@pytest.mark.parametrize('quantized', [False, True])
def test_flash_attention_buffer_kernels(randn, B, Lq, T, offset, quantized):
    q, kb, vb = randn(B, Lq, 32, 128), randn(B, T, 32, 128), randn(
        B, T, 32, 128)
    if isinstance(offset, int):
        ends, off = [offset + Lq] * B, offset
    else:
        ends = [o + Lq for o in offset]
        off = torch.tensor(offset, dtype=torch.int32, device='cuda')
    for b, end in enumerate(ends):      # a finite garbage tail, masked
        kb[b, end:] *= 10
        vb[b, end:] *= 10
    args = (kb, vb, off)
    if quantized:
        (kq, ks), (vq, vs) = kv_quantize(kb), kv_quantize(vb)
        args = (kq.transpose(1, 2).contiguous(),
                vq.transpose(1, 2).contiguous(), off,
                ks.transpose(1, 2).contiguous(),
                vs.transpose(1, 2).contiguous())
    got = flash_attention_buffer(q, *args)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == q.shape
    assert _scaled_err(got, attention_buffer_plain(q, *args)) <= 2 ** -5


def test_kernels_refuse_what_they_do_not_take(randn):
    buf = randn(1, 16, 2, 128)
    with pytest.raises(ValueError, match='do not fit'):
        flash_attention_buffer(randn(1, 8, 2, 128), buf, buf, 9)
    with pytest.raises(TypeError):
        flash_attention_buffer(randn(1, 8, 2, 128), buf.float(), buf.float(),
                               0)
    with pytest.raises(ValueError, match='head_dim'):
        flash_attention_buffer(randn(1, 8, 2, 64), buf[..., :64],
                               buf[..., :64], 0)
    with pytest.raises(ValueError, match='one type'):
        fir_gate(randn(1, 3, 8, 5), randn(3, 8, 3), None,
                 randn(1, 3, 8, 2).float())
    q = randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match='head_dim'):
        flash_attention_causal(q, q, q)
    q32 = randn(1, 8, 2, 128).float()
    with pytest.raises(TypeError):
        flash_attention_causal(q32, q32, q32)
    with pytest.raises(ValueError):
        rmsnorm(randn(2, 12), randn(12))
    with pytest.raises(TypeError):
        rmsnorm(randn(2, 16).float(), randn(16).float())
    with pytest.raises(TypeError):
        fir_gate(randn(1, 3, 8, 5).float(), randn(3, 8, 3).float())


def _int4_case(M, Kp, N, seed=0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(M, Kp, device='cuda', generator=g).bfloat16()
    q = torch.randint(-8, 8, (Kp, N), device='cuda', generator=g,
                      dtype=torch.int8)
    s = torch.rand(Kp // 128, N, device='cuda', generator=g) * 0.09 + 0.01
    return x, pack_int4(q), s


@pytest.mark.parametrize('M,Kp,N', [
    (8, 256, 512), (1, 4096, 688), (16, 1536, 512), (128, 512, 1024),
    (3, 256, 40), (5, 512, 1001),            # N off the 16-byte loads
    (1, 4096, 10928), (2, 11008, 4096), (7, 4096, 12288),
    (128, 4096, 4096), (33, 4096, 10928)])
def test_int4_matmul_kernel(M, Kp, N):
    """Kernel 8 against its plain version: the same bf16 products and
    float32 group sums in another order, so 1e-4 of the larger of the value
    and its row's rms."""
    x, packed, s = _int4_case(M, Kp, N)
    got = int4_matmul(x, packed, s)
    torch.cuda.synchronize()
    want = int4_matmul_plain(x, packed, s)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    assert ((got - want).abs() / want.abs().maximum(rms)).max() <= 1e-4


def test_int4_matmul_padded_contraction():
    """K = 128 padded to Kp = 256 (the wo case): zero rows interleave with
    real ones across the two nibbles, which a wrong pairing of byte blocks
    and scale groups would mix up."""
    from evo_tpu_torch.quant import int4_dot, quantize_weight_int4
    g = torch.Generator(device='cuda').manual_seed(1)
    w = torch.randn(2, 64, 256, device='cuda', generator=g) * 0.05
    x = torch.randn(2, 5, 2, 64, device='cuda', generator=g).bfloat16()
    qw = quantize_weight_int4(w, 2)
    before = _build.LAUNCHES['int4_matmul']
    got = int4_dot(x, qw, nc=2)
    assert _build.LAUNCHES['int4_matmul'] == before + 1
    want = int4_dot(x.cpu(), qw.cpu(), nc=2)
    assert got.shape == (2, 5, 256)
    assert torch.allclose(got.float().cpu(), want.float(), rtol=2 ** -7,
                          atol=1e-3)


def test_int4_decode_step_launches():
    """Five quantized projections a layer: a decode step launches kernel 8
    that many times, a prefill of more than 128 rows never."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.quant import quantize_params
    cfg = tiny_config(hidden_size=256, num_filters=256,
                      num_attention_heads=2, compute_dtype='bfloat16',
                      param_dtype='bfloat16', weight_quant='int4',
                      kv_quant='int8')
    g = torch.Generator(device='cuda').manual_seed(0)
    model = quantize_params(model_lib.random_init(cfg, g, 'cuda'),
                            free_source=True, mode='int4')
    ids = torch.randint(0, 512, (2, 100), device='cuda', generator=g)
    cache = model_lib.init_cache(cfg, 2, 128, 'cuda')
    _build.LAUNCHES.clear()
    logits, cache = model_lib.prefill(model, ids, cache)
    assert _build.LAUNCHES['int4_matmul'] == 0
    step, cache = model_lib.decode_step(model, logits[:, -1].argmax(-1),
                                        cache)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['int4_matmul'] == 5 * cfg.num_layers
    assert torch.isfinite(step).all()
    full = model_lib.forward(model, torch.cat(
        [ids, logits[:, -1].argmax(-1)[:, None]], dim=1))
    # bf16 activations round elsewhere on the two paths: 5% of the range
    assert (step - full[:, -1]).abs().max() <= 0.05 * full.abs().max()


def test_int4_kernel_refuses_what_it_does_not_take():
    x, packed, s = _int4_case(4, 256, 64)
    with pytest.raises(TypeError):
        int4_matmul(x.float(), packed, s)
    with pytest.raises(ValueError, match='M <= 128'):
        int4_matmul(x.repeat(40, 1), packed, s)
    with pytest.raises(ValueError, match='contiguous'):
        int4_matmul(x, packed.T.contiguous().T, s)
    with pytest.raises(ValueError, match='one device'):
        int4_matmul(x, packed.cpu(), s)
