"""The PyTorch port's CUDA kernels against their plain versions, on the
card. Without a CUDA device every test here skips.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has neither (tests/conftest.py imports JAX; skip it):

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -q
"""

import collections

import pytest
import torch

from evo_tpu_torch.layers.attention import kv_quantize
from evo_tpu_torch.ops.attention import (attention_plain,
                                         flash_attention_causal)
from evo_tpu_torch.ops.attention_buffer import (SPLIT_MAX_ROWS_BF16,
                                                attention_buffer_plain,
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


def _fir_gate_cases(randn, B, C, L):
    """The kernel against the plain version on the in-projection's
    (B, L, 3, C) buffer viewed as (B, 3, C, L), with and without each of
    b_in, fir_b and a carried tail: bit-equal, one launch each."""
    z = randn(B, L, 3, C).permute(0, 2, 3, 1)
    w = randn(3, C, 3)
    for b_in in (None, randn(3, C)):
        for fir_b in (None, randn(3, C)):
            for tail in (None, randn(B, 3, C, 2)):
                before = _build.LAUNCHES['fir_gate']
                got = fir_gate(z, w, fir_b, tail, b_in=b_in)
                torch.cuda.synchronize()
                assert _build.LAUNCHES['fir_gate'] == before + 1
                want = fir_gate_plain(z, w, fir_b, tail, b_in=b_in)
                for g, wnt in zip(got, want):
                    assert g.shape == (B, C, L) and g.is_contiguous()
                    assert torch.equal(g, wnt), (
                        B, C, L, b_in is not None, fir_b is not None,
                        tail is not None)


# the 64-position tile's edges, ragged rows (L % 8) and evo-1's 8192
@pytest.mark.parametrize('L', [1, 2, 3, 63, 64, 65, 77, 1000, 8192])
def test_fir_gate_kernel(randn, L):
    for B in (1, 2):
        for C in (256, 4096):
            _fir_gate_cases(randn, B, C, L)


def _scaled_err(got, want):
    """Largest |err| over the larger of |want| and the rms of its
    (position, head) row. Attention outputs shrink along the sequence, so
    no one absolute limit holds the late rows. Output rounding gives at
    most one bf16 step (2^-7) of that, the kernels' bf16 P a few 2^-9; the
    limit is four bf16 steps, 2^-5."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got - want).abs() / want.abs().maximum(rms)).max()


@pytest.mark.parametrize('B,L', [
    (1, 1), (1, 63), (1, 64), (2, 1000),
    # the edges of the 128-row query tile and of the TMA boxes
    (2, 127), (2, 128), (2, 129), (2, 4097)])
def test_flash_attention_kernel(randn, B, L):
    qkv = randn(B, L, 3, 32, 128)     # strided views, as the model has
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == q.shape
    assert _scaled_err(got, attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.parametrize('B,L', [(1, 1), (1, 2), (2, 77), (1, 1000)])
def test_fir_gate_kernel_with_carried_tail(randn, B, L):
    """A resumed segment: the tail is the last two biased inputs of the
    segment before; the outputs are those of the whole sequence."""
    zl, w, b = randn(B, 20 + L, 3, 4096), randn(3, 4096, 3), randn(3, 4096)
    b_in = randn(3, 4096)
    whole = fir_gate(zl.permute(0, 2, 3, 1), w, b, b_in=b_in)
    tail = (zl[:, 18:20] + b_in).permute(0, 2, 3, 1).contiguous()
    seg = zl[:, 20:].contiguous().permute(0, 2, 3, 1)
    got = fir_gate(seg, w, b, tail, b_in=b_in)
    torch.cuda.synchronize()
    for g, wh, want in zip(got, whole,
                           fir_gate_plain(seg, w, b, tail, b_in=b_in)):
        assert torch.equal(g, want)
        assert torch.equal(g, wh[..., 20:])


def test_fir_gate_kernel_refuses_other_layouts(randn):
    """The kernel reads the in-projection's buffer in place and is built
    for 3 taps: it raises, before any launch, on a contiguous (B, 3, C, L),
    on C % 8 != 0 and on another filter length."""
    _build.library()
    before = _build.LAUNCHES['fir_gate']
    with pytest.raises(ValueError, match='in place'):
        fir_gate(randn(1, 3, 256, 64), randn(3, 256, 3))
    with pytest.raises(ValueError, match='C % 8'):
        fir_gate(randn(1, 64, 3, 260).permute(0, 2, 3, 1), randn(3, 260, 3))
    with pytest.raises(ValueError, match='3 taps'):
        fir_gate(randn(1, 64, 3, 256).permute(0, 2, 3, 1), randn(3, 256, 4))
    assert _build.LAUNCHES['fir_gate'] == before


@pytest.mark.parametrize('B,Lq,T,offset', [
    (1, 128, 1024, 0),           # fresh, into a longer buffer
    (1, 128, 1024, 731),         # an unaligned offset
    (1, 100, 1024, 512),         # Lq not a multiple of the query tile
    (1, 256, 2048, 1792),        # the segment fills the buffer to the brim
    (2, 64, 1000, (100, 900)),   # per-row offsets, T not a multiple of 128
    (2, 1, 777, (5, 776)),       # one query row (decode)
    (1, 129, 1024, 127),         # 129 rows: a second query tile of one row
    (1, 129, 1024, 128),         # ... at a tile-aligned offset
    (2, 129, 1000, (60, 300)),   # per-row offsets whose rows cross a key
                                 # tile, T not a multiple of 128
    (2, 200, 1100, (127, 900)),  # the second row fills the buffer: keys
                                 # end 76 into the last tile
    (1, 1, 1000, 999),           # one query row at the buffer's last slot
    # int8: the split key range at one query row, and the two regimes
    (2, 1, 65536, (5, 60000)),   # per-row offsets, most splits of row 0
                                 # wholly past its live prefix
    (1, 1, 4096, 4095),          # the live prefix ends on a split boundary
    (1, 1, 4096, 512),           # the row's last key opens a split
    (1, 4, 3000, 2000),          # the most rows of the split regime
    (1, 5, 3000, 2000),          # the fewest of the wgmma regime
    (1, 2, 1000, (700,)),        # two rows, a device offset
    (1, 8192, 131072, 122880),   # a late segment of a 131k run
])
@pytest.mark.parametrize('quantized', [False, True])
def test_flash_attention_buffer_kernels(randn, B, Lq, T, offset, quantized):
    q, args = _buffer_case(randn, B, Lq, T, offset, quantized)
    got = flash_attention_buffer(q, *args)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == q.shape
    assert _scaled_err(got, attention_buffer_plain(q, *args)) <= 2 ** -5


def _buffer_case(randn, B, Lq, T, offset, quantized):
    """q and the buffer op's other arguments: random buffers whose tails
    past each row's last query are finite garbage (x10) the mask must keep
    out, as they are or quantised head-major."""
    q, kb, vb = randn(B, Lq, 32, 128), randn(B, T, 32, 128), randn(
        B, T, 32, 128)
    if isinstance(offset, int):
        ends, off = [offset + Lq] * B, offset
    else:
        ends = [o + Lq for o in offset]
        off = torch.tensor(offset, dtype=torch.int32, device='cuda')
    for b, end in enumerate(ends):
        kb[b, end:] *= 10
        vb[b, end:] *= 10
    if not quantized:
        return q, (kb, vb, off)
    (kq, ks), (vq, vs) = kv_quantize(kb), kv_quantize(vb)
    return q, (kq.transpose(1, 2).contiguous(),
               vq.transpose(1, 2).contiguous(), off,
               ks.transpose(1, 2).contiguous(),
               vs.transpose(1, 2).contiguous())


def test_combine_partials_kernel():
    """The combine kernel against its plain twin on random partials, some
    of them empty (m = -inf, l = 0), and the same bits on a second run: the
    partials are merged in a fixed order, without atomics."""
    from evo_tpu_torch.ops.attention_buffer import (combine_partials,
                                                    combine_partials_plain)
    g = torch.Generator(device='cuda').manual_seed(2)
    B, H, Lq, S = 2, 32, 3, 17
    m = torch.randn(B, H, Lq, S, device='cuda', generator=g) * 4
    m[0, :, :, 5:] = float('-inf')
    m[1, 3, 1, :] = float('-inf')           # a row with no key at all
    l = torch.rand(B, H, Lq, S, device='cuda', generator=g) * 50 + 1
    l[torch.isinf(m)] = 0
    acc = torch.randn(B, H, Lq, S, 128, device='cuda', generator=g) * 10
    acc[torch.isinf(m)] = 0
    before = _build.LAUNCHES['combine_partials']
    got = combine_partials(m, l, acc)
    again = combine_partials(m, l, acc)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['combine_partials'] == before + 2
    want = combine_partials_plain(m, l, acc)
    assert got.shape == (B, Lq, H, 128) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert not got[1, 1, 3].any() and not want[1, 1, 3].any()
    # one bf16 rounding of each output apart at most (the empty row, zeros
    # on both sides, has no scale)
    got[1, 1, 3] = want[1, 1, 3] = 1
    assert _scaled_err(got, want) <= 2 ** -7


def test_bf16_decode_step_takes_kernel_4():
    """On the card a decode step over a bf16 cache launches the buffer
    kernel once an attention layer, at one query row, and allocates no
    float32 copy of the cache."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    cfg = tiny_config(hidden_size=256, num_filters=256,
                      num_attention_heads=2, compute_dtype='bfloat16',
                      param_dtype='bfloat16')
    g = torch.Generator(device='cuda').manual_seed(0)
    model = model_lib.random_init(cfg, g, 'cuda')
    ids = torch.randint(0, 512, (2, 100), device='cuda', generator=g)
    T = 8192
    cache = model_lib.init_cache(cfg, 2, T, 'cuda')
    logits, cache = model_lib.prefill(model, ids, cache)
    tok = logits[:, -1].argmax(-1)
    _build.LAUNCHES.clear()
    step, cache = model_lib.decode_step(model, tok, cache)
    torch.cuda.synchronize()
    n_attn = len(cfg.attn_layer_idxs)
    assert _build.LAUNCHES['flash_attention_buffer'] == n_attn
    full = model_lib.forward(model, torch.cat([ids, tok[:, None]], dim=1))
    # bf16 activations round elsewhere on the two paths: 5% of the range
    assert (step - full[:, -1]).abs().max() <= 0.05 * full.abs().max()
    # at the end of the buffer: a float32 copy of one layer's live k alone
    # would take B T H Dh 4 bytes
    cache['offset'] = T - 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step, cache = model_lib.decode_step(model, tok, cache)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['flash_attention_buffer'] == 2 * n_attn
    assert torch.cuda.max_memory_allocated() - base < 2 * T * 2 * 128 * 4
    assert torch.isfinite(step).all()


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


def test_attention_kernels_refuse_misaligned_operands(randn):
    """TMA takes 16-byte aligned bases and strides only: the wrappers
    refuse anything else before any launch."""
    _build.library()
    before = dict(_build.LAUNCHES)
    odd = randn(1, 8, 2, 132)[..., :128]             # head stride 132
    shifted = randn(1 * 8 * 2 * 128 + 1)[1:].view(1, 8, 2, 128)
    q = randn(1, 8, 2, 128)
    for bad in (odd, shifted):
        with pytest.raises(ValueError, match='16 bytes'):
            flash_attention_causal(bad, q, q)
        with pytest.raises(ValueError, match='16 bytes'):
            flash_attention_causal(q, q, bad)
    buf = randn(1, 16, 2, 132)[..., :128]
    with pytest.raises(ValueError, match='16 bytes'):
        flash_attention_buffer(q, buf, buf, 0)
    assert dict(_build.LAUNCHES) == before
    flash_attention_causal(q, q, q)
    flash_attention_buffer(q, q.contiguous(), q.contiguous(), 0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['flash_attention'] == before.get(
        'flash_attention', 0) + 1
    assert _build.LAUNCHES['flash_attention_buffer'] == before.get(
        'flash_attention_buffer', 0) + 1


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


# evo-1's four weight shapes as (K, Kp, N): w1 / w2, w3 (K padded to Kp),
# w_in / wqkv, w_out
_LAYER_SHAPES = [(4096, 4096, 10928), (10928, 11008, 4096),
                 (4096, 4096, 12288), (4096, 4096, 4096)]


# the wgmma design's row counts: each of its instances (n = 16, 32, 64,
# 128) at its ends and inside
_MMA_ROWS = (5, 9, 16, 17, 24, 32, 33, 64, 65, 100, 127, 128)


@pytest.mark.parametrize('M,K,Kp,N', [
    *[(M, K, Kp, N) for K, Kp, N in _LAYER_SHAPES
      for M in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 128)],
    *[(M, K, Kp, N) for K, Kp, N in _LAYER_SHAPES
      for M in (17, 24, 32, 33, 64, 65, 100, 127)],
    *[(M, 1000, 1024, 1001) for M in (1, 2, 5, 8, 9, 33)],  # ragged N, K
    *[(M, 1000, 1024, 1001) for M in _MMA_ROWS if M not in (5, 9, 33)],
    # 17 steps (Kp / 256): an odd count, at the streaming design's rows
    # and the wgmma design's fewest
    *[(M, 4300, 4352, 600) for M in (1, 2, 3, 4)],
    *[(M, 4300, 4352, 600) for M in _MMA_ROWS],
    (1, 40, 256, 24), (8, 130, 512, 136), (100, 130, 512, 136)])
def test_int4_matmul_rows_and_outputs(M, K, Kp, N):
    """Kernel 8 on an x of K <= Kp columns (the rest read as zeros) at every
    row count of its two designs: within 1e-4 of the plain version in
    float32, bit-equal from run to run (the splits' parts are added in a
    fixed order), and its bf16 output the float32 one rounded once."""
    x, packed, s = _int4_case(M, Kp, N, seed=M + K)
    x = x[:, :K].contiguous()
    before = _build.LAUNCHES['int4_matmul']
    got = int4_matmul(x, packed, s)
    again = int4_matmul(x, packed, s)
    got16 = int4_matmul(x, packed, s, torch.bfloat16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['int4_matmul'] == before + 3
    want = int4_matmul_plain(x, packed, s)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert got16.dtype == torch.bfloat16 and got16.shape == (M, N)
    assert torch.equal(got, again)
    assert torch.equal(got16, got.bfloat16())
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    assert ((got - want).abs() / want.abs().maximum(rms)).max() <= 1e-4
    assert torch.equal(int4_matmul_plain(x, packed, s, torch.bfloat16),
                       want.bfloat16())


def test_int4_matmul_in_a_cuda_graph():
    """Kernel 8's streaming design replayed from a CUDA graph (as a
    captured decode step would run it): the splits are summed in order, so
    every replay is bit-equal to the eager call, and the tickets (one a
    column tile) are back at zero after each launch."""
    from evo_tpu_torch.ops import int4 as int4_mod
    x, packed, s = _int4_case(2, 4096, 12288)
    splits, tiles = int4_mod.gemv_plan(4096, 12288)
    assert splits > 1
    first = int4_matmul(x, packed, s, torch.bfloat16)
    torch.cuda.synchronize()
    tickets = int4_mod._TICKETS[x.device]
    assert int(tickets[:tiles].abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int4_matmul(x, packed, s, torch.bfloat16)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert int(tickets[:tiles].abs().sum()) == 0


@pytest.mark.parametrize('M', [9, 128])
def test_int4_matmul_wgmma_in_a_cuda_graph(M):
    """Kernel 8's wgmma design replayed from a CUDA graph: tiles split
    between blocks are added in block order, so every replay is bit-equal
    to the eager call, and the tickets are back at zero after each
    launch; an eager call between replays takes the same workspace of
    partial sums as the graph and leaves it fit for the next replay."""
    from evo_tpu_torch.ops import int4 as int4_mod
    x, packed, s = _int4_case(M, 4096, 12288, seed=M)
    _n, cols, _blocks, parts = int4_mod.mma_plan(
        M, 4096, 12288, _build.sm_count(x.device.index))
    assert M > int4_mod.GEMV_M_MAX and parts > 1
    tiles = -(-12288 // cols)
    first = int4_matmul(x, packed, s, torch.bfloat16)
    torch.cuda.synchronize()
    tickets = int4_mod._TICKETS[x.device]
    assert int(tickets[:tiles].abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int4_matmul(x, packed, s, torch.bfloat16)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
        assert int(tickets[:tiles].abs().sum()) == 0
        assert torch.equal(int4_matmul(x, packed, s, torch.bfloat16), first)


@pytest.mark.parametrize('M,K,Kp,N', [
    *[(M, K, Kp, N) for K, Kp, N in _LAYER_SHAPES
      for M in (1, 2, 4, 5, 9, 128)],
    *[(M, 1000, 1024, 1001) for M in (1, 3, 9, 33)],    # ragged N, K
    (1, 40, 256, 24), (8, 130, 512, 136), (2, 4300, 4352, 600),
    # the wgmma design's instances, at evo-1's w3 (K < Kp) and ragged
    *[(M, K, Kp, N) for K, Kp, N in [_LAYER_SHAPES[1], (1000, 1024, 1001),
                                      (4300, 4352, 600)]
      for M in _MMA_ROWS if (M, K) not in ((5, 10928), (9, 10928),
                                           (9, 1000), (33, 1000))],
    (100, 130, 512, 136)])
@pytest.mark.parametrize('mode', ['block', 'dots8'])
def test_int4_other_modes_kernel(mode, M, K, Kp, N):
    """Kernel 8's 'block' instance (both designs) and the 'dots8' kernel
    against their plain versions: 'block' within 1e-4 of the larger of the
    value and its row's rms (the same bf16 products, float32 sums in
    another order); 'dots8' bit-equal (exact integer dots, its float32 sums
    in the plain version's order); both bit-equal run to run, the bf16
    output the float32 one rounded once, one launch a call under its own
    counter."""
    from evo_tpu_torch.ops.int4 import (int4_matmul_block_plain,
                                        int4_matmul_dots8_plain)
    x, packed, s = _int4_case(M, Kp, N, seed=M + K + N)
    x = x[:, :K].contiguous()
    counter = f'int4_matmul_{mode}'
    before = _build.LAUNCHES[counter]
    got = int4_matmul(x, packed, s, mode=mode)
    again = int4_matmul(x, packed, s, mode=mode)
    got16 = int4_matmul(x, packed, s, torch.bfloat16, mode=mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 3
    assert torch.equal(got, again)
    assert torch.equal(got16, got.bfloat16())
    if mode == 'dots8':
        assert torch.equal(got, int4_matmul_dots8_plain(x, packed, s))
    else:
        want = int4_matmul_block_plain(x, packed, s)
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        assert ((got - want).abs() / want.abs().maximum(rms)).max() <= 1e-4


def test_int4_other_modes_refuse_grad():
    x, packed, s = _int4_case(2, 256, 64)
    x.requires_grad_()
    for mode in ('block', 'dots8'):
        with pytest.raises(RuntimeError, match='no backward'):
            int4_matmul(x, packed, s, mode=mode)


def test_fft_backend_forward_on_the_card():
    """A small bf16 model under hyena_conv_backend='fft' (monolithic and
    chunked) on the card: kernels 1-3 launch as under 'matmul', the fused
    mixer never, and the logits stay within one bf16 rounding's drift of
    the matmul backend's (2^-5 of the logits' scale)."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    base = tiny_config(hidden_size=256, num_filters=256,
                       num_attention_heads=2, compute_dtype='bfloat16',
                       param_dtype='bfloat16', hyena_fused_mixer=True)
    g = torch.Generator(device='cuda').manual_seed(0)
    model = model_lib.random_init(base, g, 'cuda')
    ids = torch.randint(0, 512, (2, 192), device='cuda', generator=g)
    want = model_lib.forward(model, ids, base.replace(
        hyena_fused_mixer=False))
    for chunk in (0, 64):
        cfg = base.replace(hyena_conv_backend='fft', hyena_fft_chunk=chunk)
        _build.LAUNCHES.clear()
        got = model_lib.forward(model, ids, cfg)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {'rmsnorm': 2 * cfg.num_layers + 1,
                                         'fir_gate': 3,
                                         'flash_attention': 1}
        assert (got - want).abs().max() <= 2 ** -5 * want.abs().max()


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


def _modal(C, S, seed=0):
    """Stable random poles (|p| in 0.5..0.98) and residues, (C, S, 2)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    mag = torch.rand(C, S, device='cuda', generator=g) * 0.48 + 0.5
    ang = (torch.rand(C, S, device='cuda', generator=g) * 2 - 1) * 3.1
    poles = torch.stack([mag * torch.cos(ang), mag * torch.sin(ang)], -1)
    residues = torch.randn(C, S, 2, device='cuda', generator=g) * 0.3
    return poles, residues


def _in_place(zl):
    """The (B, 3, C, L) streams as the layer passes them: the view of the
    in-projection's (B, L, 3, C) output."""
    return zl.permute(0, 2, 3, 1)


# C a multiple of 8 throughout: the kernel's rule, and the JAX package's
@pytest.mark.parametrize('B,C,L,chunk,S,Kf', [
    (1, 4096, 8192, 64, 8, 3),   # evo-1's widths and length
    (2, 4096, 512, 64, 8, 3),
    (2, 64, 64, 64, 8, 3),       # one whole chunk
    (2, 104, 1024, 64, 8, 3),    # a channel tile of 16 half full
    (1, 40, 64, 16, 4, 3),       # a small chunk, 4 states
    (2, 64, 37, 64, 8, 3),       # L < chunk: one chunk of odd width
    (1, 16, 63, 21, 8, 3),       # odd chunks
    (1, 8, 48, 8, 2, 3),         # 2 states, a chunk of 8
    (1, 16, 8, 1, 8, 3),         # chunks of one position
    (1, 8, 3, 64, 8, 3),         # L = short_filter_length
    (2, 8, 1, 64, 8, 3),         # L below the FIR tail's width
])
@pytest.mark.parametrize('bias', [True, False])
@pytest.mark.parametrize('b_in', [True, False])
@pytest.mark.parametrize('carried', [False, True])
def test_hyena_mixer_kernel(randn, B, C, L, chunk, S, Kf, bias, b_in,
                            carried):
    """Kernel 6 on the in-place view against the unfused composition. The
    bias add and the FIR are bit-equal by construction; the long conv's
    float32 sums run in another order, so y agrees to float32 rounding
    before it is rounded to bf16 and an output may land one bf16 step
    (2^-8..2^-7 of its size) away: at most 2^-6 of the larger of the value
    and its row's rms, and 99 % of outputs equal. The modal state stays
    float32: 1e-4 of the same scale. y lies as (B, L, C)."""
    from evo_tpu_torch.ops.hyena_mixer import (hyena_mixer, hyena_mixer_plain,
                                               hyena_mixer_supported)
    z, w = _in_place(randn(B, L, 3, C)), randn(3, C, Kf) * 0.5
    b = randn(3, C) * 0.1 if bias else None
    bi = randn(3, C) * 0.3 if b_in else None
    poles, residues = _modal(C, S)
    d_skip = randn(C)
    state = None
    if carried:
        state = (randn(B, 3, C, Kf - 1), randn(B, C, S, 2).float())
    assert hyena_mixer_supported(z.shape, chunk, S, Kf)
    before = _build.LAUNCHES['hyena_mixer']
    y, iir, fir = hyena_mixer(z, w, b, poles, residues, d_skip, chunk=chunk,
                              state=state, b_in=bi)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['hyena_mixer'] == before + 1
    y_want, iir_want, fir_want = hyena_mixer_plain(
        z, w, b, poles, residues, d_skip, chunk=chunk, state=state, b_in=bi)
    assert y.dtype == z.dtype and y.shape == (B, C, L)
    assert y.transpose(1, 2).is_contiguous()
    assert iir.dtype == torch.float32 and iir.shape == (B, C, S, 2)
    assert torch.equal(fir, fir_want)
    assert _scaled_err(y, y_want) <= 2 ** -6
    assert (y == y_want).float().mean() >= 0.99
    assert _scaled_err(iir.flatten(2), iir_want.flatten(2)) <= 1e-4


def test_hyena_mixer_segments_continue(randn):
    """Two halves with the carried (fir, iir) state against one pass."""
    from evo_tpu_torch.ops.hyena_mixer import hyena_mixer
    B, C, L, S = 2, 64, 1024, 8
    zl, w, b = randn(B, L, 3, C), randn(3, C, 3) * 0.5, randn(3, C) * 0.1
    bi = randn(3, C) * 0.3
    poles, residues = _modal(C, S, seed=1)
    d_skip = randn(C)
    y, iir, fir = hyena_mixer(_in_place(zl), w, b, poles, residues, d_skip,
                              chunk=64, b_in=bi)
    h = L // 2
    y1, iir1, fir1 = hyena_mixer(_in_place(zl[:, :h].contiguous()), w, b,
                                 poles, residues, d_skip, chunk=64, b_in=bi)
    y2, iir2, fir2 = hyena_mixer(_in_place(zl[:, h:].contiguous()), w, b,
                                 poles, residues, d_skip, chunk=64,
                                 state=(fir1, iir1), b_in=bi)
    torch.cuda.synchronize()
    assert torch.equal(fir2, fir)
    assert _scaled_err(torch.cat([y1, y2], -1), y) <= 2 ** -6
    assert _scaled_err(iir2.flatten(2), iir.flatten(2)) <= 1e-4


@pytest.mark.parametrize('B,D,K,S,chunk', [
    (1, 4096, 128, 8, 64),      # a forward of 8,192 at evo-1's width
    (2, 32, 16, 4, 32),
    (1, 16, 48, 8, 64),         # K no power of two
    (1, 8, 2, 2, 128),          # the least K
    (3, 7, 13, 5, 64),          # nothing a multiple of anything
])
def test_modal_prefix_kernel(B, D, K, S, chunk):
    """Kernel 7 (a serial walk) against the doubling loop: the same sums
    in another order, 2e-5 of the larger of the value and its channel's
    rms (the JAX test's own tolerance for kernel against loop)."""
    from evo_tpu_torch.ops.modal_prefix import (modal_prefix,
                                                modal_prefix_plain)
    g = torch.Generator(device='cuda').manual_seed(K)
    inj_r = torch.randn(B, D, K, S, device='cuda', generator=g)
    inj_i = torch.randn(B, D, K, S, device='cuda', generator=g)
    logmag = torch.log(torch.rand(D, S, device='cuda', generator=g) * 0.48
                       + 0.5)
    theta = (torch.rand(D, S, device='cuda', generator=g) * 2 - 1) * 3.1
    before = _build.LAUNCHES['modal_prefix']
    got = modal_prefix(inj_r, inj_i, logmag, theta, chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['modal_prefix'] == before + 1
    want = modal_prefix_plain(inj_r, inj_i, logmag, theta, chunk)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        # rms over a channel's chunks and states: ent[0] is all zeros
        assert _scaled_err(a.flatten(2), b.flatten(2)) <= 2e-5


def _prefix_inputs(B, D, K, S, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    inj_r = torch.randn(B, D, K, S, device='cuda', generator=g)
    inj_i = torch.randn(B, D, K, S, device='cuda', generator=g)
    logmag = torch.log(torch.rand(D, S, device='cuda', generator=g) * 0.48
                       + 0.5)
    theta = (torch.rand(D, S, device='cuda', generator=g) * 2 - 1) * 3.1
    s0 = torch.randn(B, D, S, 2, device='cuda', generator=g)
    return inj_r, inj_i, logmag, theta, s0


@pytest.mark.parametrize('K', [2, 3, 127, 128, 188, 256])
@pytest.mark.parametrize('B', [1, 2])
@pytest.mark.parametrize('S', [8, 5])
def test_modal_prefix_kernel_segments_and_state(K, B, S):
    """Kernel 7's segments (16 a warp at S = 8, 6 at S = 5) against the
    doubling loop, with and without a carried state s0 (ent[0] = s0, the
    later terms a^k s0): 2e-5 of the larger of the value and its
    channel's rms."""
    from evo_tpu_torch.ops.modal_prefix import (modal_prefix,
                                                modal_prefix_plain)
    inj_r, inj_i, logmag, theta, s0 = _prefix_inputs(B, 96, K, S, K + S)
    for state in (None, s0):
        before = _build.LAUNCHES['modal_prefix']
        got = modal_prefix(inj_r, inj_i, logmag, theta, 64, state)
        torch.cuda.synchronize()
        assert _build.LAUNCHES['modal_prefix'] == before + 1
        want = modal_prefix_plain(inj_r, inj_i, logmag, theta, 64, state)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == torch.float32
            assert _scaled_err(a.flatten(2), b.flatten(2)) <= 2e-5
        if state is not None:
            assert torch.equal(got[0][:, :, 0], s0[..., 0])
            assert torch.equal(got[1][:, :, 0], s0[..., 1])


def test_modal_prefix_kernel_reads_the_einsum_layout():
    """The injection einsum leaves (B, D, K, S) with the batch inside the
    channel; the kernel reads that layout in place, writes ent in it, and
    agrees with the contiguous call bit for bit."""
    from evo_tpu_torch.ops.modal_prefix import modal_prefix
    inj_r, inj_i, logmag, theta, s0 = _prefix_inputs(2, 64, 128, 8, 5)
    pr = inj_r.transpose(0, 1).contiguous().transpose(0, 1)
    pi = inj_i.transpose(0, 1).contiguous().transpose(0, 1)
    assert not pr.is_contiguous()
    got = modal_prefix(pr, pi, logmag, theta, 64, s0)
    want = modal_prefix(inj_r, inj_i, logmag, theta, 64, s0)
    assert got[0].stride() == pr.stride()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_modal_prefix_kernel_decay_within_two_ulp():
    """a = p^chunk computed inside the kernel (expf, sincosf) against
    torch's `_pole_pow_tables` on the card: with inj[0] = 1 and inj[1] = 0
    over K = 2 chunks the final state is a itself, exactly."""
    from evo_tpu_torch.ops.modal_prefix import _pole_pow_tables, modal_prefix
    _, _, logmag, theta, _ = _prefix_inputs(1, 4096, 2, 8, 9)
    inj_r = torch.zeros(1, 4096, 2, 8, device='cuda')
    inj_r[:, :, 0] = 1
    inj_i = torch.zeros_like(inj_r)
    for chunk in (64, 16, 1):
        _, _, fr, fi = modal_prefix(inj_r, inj_i, logmag, theta, chunk)
        want = _pole_pow_tables(logmag, theta, float(chunk))
        for got, w in zip((fr[0], fi[0]), want):
            ulp = (torch.nextafter(w.abs(), torch.full_like(w, float('inf')))
                   - w.abs())
            assert ((got - w).abs() <= 2 * ulp).all()


def test_conv_matmul_chunked_prefix_kernel():
    """`pallas_prefix=True` against False, fresh and with a carried
    state (the kernel serves both; the state's terms are added outside)."""
    from evo_tpu_torch.ops.fftconv import conv_matmul_chunked
    g = torch.Generator(device='cuda').manual_seed(3)
    B, D, L, S, chunk = 2, 24, 512, 8, 64
    u = torch.randn(B, D, L, device='cuda', generator=g)
    poles, residues = _modal(D, S, seed=3)
    d_skip = torch.randn(D, device='cuda', generator=g)
    for state in (None, torch.randn(B, D, S, 2, device='cuda', generator=g)):
        before = _build.LAUNCHES['modal_prefix']
        y1, s1 = conv_matmul_chunked(u, poles, residues, chunk, state=state,
                                     d_skip=d_skip, pallas_prefix=True)
        assert _build.LAUNCHES['modal_prefix'] == before + 1
        y0, s0 = conv_matmul_chunked(u, poles, residues, chunk, state=state,
                                     d_skip=d_skip)
        assert _build.LAUNCHES['modal_prefix'] == before + 1
        assert torch.allclose(y1, y0, rtol=2e-4, atol=2e-4)
        assert torch.allclose(s1, s0, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('M,D,I,act', [
    # both tile shapes (64 x 64 at M <= 64, 128 x 128 above) and their
    # edges, at evo-1's widths
    *[(M, 4096, 10928, 'gelu') for M in (1, 63, 64, 65, 129, 8192)],
    (33, 4100, 10930, 'gelu'),       # D and I padded to multiples of 8
    (64, 128, 176, 'gelu'), (300, 256, 336, 'gelu'), (128, 384, 128, 'gelu'),
    (80, 128, 144, 'silu'),          # the JAX tests' shapes
    (2, 4096, 10928, 'gelu'),        # decode rows at evo-1's widths
    (1000, 4096, 10928, 'gelu'),     # ragged M and I (10928 = 170 * 64 + 48)
    (37, 100, 77, 'gelu_tanh'),      # nothing aligned: element-wise loads
    (129, 72, 1001, 'relu'),
    (5, 40, 24, 'identity'),
])
def test_mlp_gate_kernel(randn, M, D, I, act):
    """Kernel 9 against float32 products: both sum exact bf16 x bf16
    products in float32, in another order, and round once to bf16, so an
    output may land one bf16 step away: 2^-6 of the larger of the value
    and its row's rms."""
    from evo_tpu_torch.ops.mlp_gate import fused_gate, fused_gate_plain
    x = randn(M, D)
    w1, w2 = randn(D, I) * D ** -0.5, randn(D, I) * D ** -0.5
    before = _build.LAUNCHES['mlp_gate']
    got = fused_gate(x, w1, w2, act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['mlp_gate'] == before + 1
    want = fused_gate_plain(x, w1, w2, act)
    assert got.dtype == x.dtype and got.shape == (M, I)
    assert _scaled_err(got, want) <= 2 ** -6


def test_mlp_gate_leading_dims(randn):
    from evo_tpu_torch.ops.mlp_gate import fused_gate, fused_gate_plain
    x, w1, w2 = randn(2, 40, 128), randn(128, 144) * 0.05, randn(128, 144) * 0.05
    got = fused_gate(x, w1, w2, 'silu')
    torch.cuda.synchronize()
    assert got.shape == (2, 40, 144)
    assert _scaled_err(got, fused_gate_plain(x, w1, w2, 'silu')) <= 2 ** -6


def test_new_kernels_refuse_what_they_do_not_take(randn):
    from evo_tpu_torch.ops.hyena_mixer import (hyena_mixer,
                                               hyena_mixer_supported)
    from evo_tpu_torch.ops.mlp_gate import fused_gate
    from evo_tpu_torch.ops.modal_prefix import modal_prefix
    poles, residues = _modal(8, 8)
    z, w, d = _in_place(randn(1, 100, 3, 8)), randn(3, 8, 3), randn(8)
    z64 = _in_place(randn(1, 64, 3, 8))
    assert not hyena_mixer_supported(z.shape, 64)        # 100 % 64
    with pytest.raises(ValueError, match='hyena_mixer_supported'):
        hyena_mixer(z, w, None, poles, residues, d, chunk=64)
    with pytest.raises(ValueError, match='hyena_mixer_supported'):
        hyena_mixer(_in_place(randn(1, 128, 3, 8)), w, None, poles,
                    residues, d, chunk=128)              # a chunk above 64
    assert not hyena_mixer_supported((1, 3, 8, 64), 64, 8, 4)
    with pytest.raises(ValueError, match='hyena_mixer_supported'):
        hyena_mixer(z64, randn(3, 8, 4), None, poles, residues, d,
                    chunk=64)                            # a FIR of 4 taps
    p12, r12 = _modal(12, 8)
    with pytest.raises(ValueError, match='hyena_mixer_supported'):
        hyena_mixer(_in_place(randn(1, 64, 3, 12)), randn(3, 12, 3), None,
                    p12, r12, randn(12), chunk=64)       # C % 8 != 0
    with pytest.raises(TypeError):
        hyena_mixer(z64.float(), w.float(), None, poles, residues,
                    d.float(), chunk=64)
    with pytest.raises(TypeError):    # fp32 taps beside a bf16 d_skip
        hyena_mixer(z64, w.float(), None, poles, residues, d, chunk=64)
    with pytest.raises(ValueError, match='do not match'):
        hyena_mixer(z64, w, None, poles[:4], residues, d, chunk=64)
    # the contiguous (B, 3, C, L) streams, and a base off 16 bytes: the
    # kernel reads the in-projection's output in place and copies nothing
    with pytest.raises(ValueError, match='in place'):
        hyena_mixer(randn(1, 3, 8, 64), w, None, poles, residues, d,
                    chunk=64)
    flat = randn(64 * 3 * 8 + 1)
    with pytest.raises(ValueError, match='in place'):
        hyena_mixer(_in_place(flat[1:].view(1, 64, 3, 8)), w, None, poles,
                    residues, d, chunk=64)
    before = _build.LAUNCHES['hyena_mixer']
    hyena_mixer(_in_place(flat[:-1].view(1, 64, 3, 8)), w, None, poles,
                residues, d, chunk=64)
    assert _build.LAUNCHES['hyena_mixer'] == before + 1
    x = randn(4, 64)
    with pytest.raises(TypeError):
        fused_gate(x.float(), randn(64, 32).float(), randn(64, 32).float())
    with pytest.raises(ValueError, match='must both be'):
        fused_gate(x, randn(64, 32), randn(64, 40))
    with pytest.raises(ValueError, match='unknown activation'):
        fused_gate(x, randn(64, 32), randn(64, 32), 'swish')
    inj = torch.randn(1, 4, 6, 2, device='cuda')
    with pytest.raises(TypeError):
        modal_prefix(inj.double(), inj.double(), torch.zeros(4, 2).cuda(),
                     torch.zeros(4, 2).cuda(), 64)
    with pytest.raises(ValueError, match='pole logs'):
        modal_prefix(inj, inj, torch.zeros(3, 2).cuda(),
                     torch.zeros(3, 2).cuda(), 64)


def test_fused_model_launches():
    """With `hyena_fused_mixer` a forward launches the fused kernel once a
    Hyena layer and the FIR + gate kernel never, where the shape rule
    holds; a ragged length falls through, in both directions by the rule
    alone. With `hyena_pallas_prefix` alone the prefix kernel runs once a
    Hyena layer beside FIR + gate."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    base = dict(hidden_size=256, num_filters=256, num_attention_heads=2,
                compute_dtype='bfloat16', param_dtype='bfloat16')
    cfg = tiny_config(**base)
    model = model_lib.random_init(cfg, torch.Generator(device='cuda')
                                  .manual_seed(0), 'cuda')
    g = torch.Generator(device='cuda').manual_seed(1)
    n_hyena = len(cfg.hyena_layer_idxs)
    want = {}
    for L in (128, 100):
        ids = torch.randint(0, 512, (2, L), device='cuda', generator=g)
        want[L] = model_lib.forward(model, ids)
        for fields, counts in (
                (dict(hyena_fused_mixer=True),
                 {'hyena_mixer': n_hyena if L % 64 == 0 else 0,
                  'fir_gate': 0 if L % 64 == 0 else n_hyena,
                  'modal_prefix': 0}),
                (dict(hyena_pallas_prefix=True),
                 {'hyena_mixer': 0, 'fir_gate': n_hyena,
                  'modal_prefix': n_hyena}),
                (dict(hyena_fused_mixer=True, hyena_pallas_prefix=True),
                 {'hyena_mixer': n_hyena if L % 64 == 0 else 0,
                  'fir_gate': 0 if L % 64 == 0 else n_hyena,
                  'modal_prefix': 0 if L % 64 == 0 else n_hyena})):
            model.config = cfg.replace(**fields)
            _build.LAUNCHES.clear()
            got = model_lib.forward(model, ids)
            torch.cuda.synchronize()
            assert {k: _build.LAUNCHES[k] for k in counts} == counts, (
                L, fields, dict(_build.LAUNCHES))
            # bf16 activations round elsewhere on the two paths
            assert (got - want[L]).abs().max() <= 0.05 * want[L].abs().max()
        model.config = cfg


# -- continuous batching: per-row decode offsets --------------------------------

@pytest.mark.parametrize('T', [2048, 8192])
@pytest.mark.parametrize('quantized', [False, True])
def test_buffer_kernels_one_row_per_row_offsets(randn, T, quantized):
    """Kernels 4 and 5 at one query row over a slot batch of four rows at
    offsets (0, 17, T - 129, T - 1), read from the device, against their
    plain versions."""
    q, args = _buffer_case(randn, 4, 1, T, (0, 17, T - 129, T - 1),
                           quantized)
    name = 'flash_attention_buffer_q8' if quantized else \
        'flash_attention_buffer'
    before = _build.LAUNCHES[name]
    combines = _build.LAUNCHES['combine_partials']
    got = flash_attention_buffer(q, *args)
    torch.cuda.synchronize()
    # the split kernel, then the combine kernel
    assert _build.LAUNCHES[name] == before + 1
    assert _build.LAUNCHES['combine_partials'] == combines + 1
    assert _scaled_err(got, attention_buffer_plain(q, *args)) <= 2 ** -5


# -- kernel 4 at 1-16 query rows: the bf16 split key range --------------------

@pytest.mark.parametrize('B,Lq,T,offset', [
    (1, 1, 1000, 999),           # one row at the last slot, T % 64 != 0
    (2, 1, 777, (5, 776)),       # per-row offsets, one near 0, one near T
    (1, 1, 4096, 4095),          # the live prefix ends on a split edge
    (1, 1, 4096, 511),           # ... and on a 64-key tile's edge
    (2, 1, 65536, (5, 60000)),   # most splits of row 0 past its prefix
    (1, 2, 3000, 2000), (1, 4, 3000, 2000), (1, 8, 3000, 2000),
    (1, 9, 8100, 8000),          # a g = 8 verify pass
    (1, 16, 3000, 2000),         # the most rows of the split regime
    (1, 16, 1000, 0),            # rows at the start: row r sees r + 1 keys
    (2, 16, 1000, (100, 984)),   # per-row offsets, the second to the brim
    (4, 9, 2048, (0, 17, 1919, 2039)),
    (1, 1, 131072, 122879),      # a decode step late in a 131k run
])
def test_bf16_split_kernel(randn, B, Lq, T, offset):
    """Kernel 4 at up to SPLIT_MAX_ROWS_BF16 rows: one launch of the split
    kernel and one of the combine kernel, within 2^-5 scaled of the plain
    version, and the same bits on a second run (fixed merge order, no
    atomics)."""
    assert Lq <= SPLIT_MAX_ROWS_BF16
    q, args = _buffer_case(randn, B, Lq, T, offset, False)
    before = collections.Counter(_build.LAUNCHES)
    got = flash_attention_buffer(q, *args)
    again = flash_attention_buffer(q, *args)
    torch.cuda.synchronize()
    ran = collections.Counter(_build.LAUNCHES)
    ran.subtract(before)
    assert +ran == {'flash_attention_buffer': 2, 'combine_partials': 2}
    assert got.is_contiguous() and got.shape == q.shape
    assert torch.equal(got, again)
    assert _scaled_err(got, attention_buffer_plain(q, *args)) <= 2 ** -5


@pytest.mark.parametrize('Lq,offset', [(1, (512, 530)), (9, (100, 900)),
                                       (16, (0, 1000))])
@pytest.mark.parametrize('quantized', [False, True])
def test_split_kernels_read_strided_views(randn, Lq, offset, quantized):
    """A tp = 2 rank's 16 heads as the Ulysses all-to-all leaves them:
    views of 32-head tensors (head stride 128, position stride 4,096),
    through both split kernels (kernel 5 where it splits)."""
    T, H = 1024, 16
    q = randn(2, Lq, 2 * H, 128)[:, :, H:]
    kb, vb = (randn(2, T, 2 * H, 128)[:, :, :H] for _ in range(2))
    off = torch.tensor(offset, dtype=torch.int32, device='cuda')
    if quantized:
        (kq, ks), (vq, vs) = kv_quantize(kb), kv_quantize(vb)
        args = (kq.transpose(1, 2), vq.transpose(1, 2), off,
                ks.transpose(1, 2).contiguous(),
                vs.transpose(1, 2).contiguous())
    else:
        args = (kb, vb, off)
    assert not q.is_contiguous() and not args[0].is_contiguous()
    got = flash_attention_buffer(q, *args)
    torch.cuda.synchronize()
    assert _scaled_err(got, attention_buffer_plain(q, *args)) <= 2 ** -5


def test_bf16_split_in_a_cuda_graph(randn):
    """The split's grid follows the buffer, not the offsets: one captured
    decode attention replays at other device offsets, each replay within
    2^-5 scaled of the plain version."""
    B, T = 2, 4096
    q, kb, vb = randn(B, 1, 32, 128), randn(B, T, 32, 128), randn(
        B, T, 32, 128)
    off = torch.tensor([5, 100], dtype=torch.int32, device='cuda')
    flash_attention_buffer(q, kb, vb, off)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_buffer(q, kb, vb, off)
    for offsets in ((5, 100), (4095, 0), (2000, 3071), (63, 64)):
        off.copy_(torch.tensor(offsets, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert _scaled_err(out, attention_buffer_plain(q, kb, vb, off)) \
            <= 2 ** -5, offsets


@pytest.mark.parametrize('quantized', [False, True])
def test_split_sized_on_the_device_over_a_long_cache(randn, quantized):
    """Both splits at one row over 8,192 live keys of a 131,072-slot cache:
    with a (1,) device offset the wrapper sizes S from the whole buffer
    and each block its range from the offset; with an int offset, S from
    the live prefix. Here the two give the same ranges (and an empty one
    more from the device offset), so the same bits, and the plain
    version's result within 2^-5 scaled."""
    q, args = _buffer_case(randn, 1, 1, 131072, 8191, quantized)
    dev_off = torch.tensor([8191], dtype=torch.int32, device='cuda')
    on_device = flash_attention_buffer(
        q, *args[:2], dev_off, *args[3:])
    as_int = flash_attention_buffer(q, *args)
    torch.cuda.synchronize()
    assert torch.equal(on_device, as_int)
    assert _scaled_err(on_device, attention_buffer_plain(q, *args)) \
        <= 2 ** -5


@pytest.mark.parametrize('quantized', [False, True])
def test_kv_write_per_row_offsets(randn, quantized):
    """The per-row index write of one decode position a row, into a bf16
    (B, T, H, Dh) cache and a head-major int8 (B, H, T, Dh) one with
    (B, H, T) scales, against a plain loop over the rows."""
    from evo_tpu_torch.layers.attention import _kv_write
    B, T, H = 4, 300, 32
    k, v = randn(B, 1, H, 128), randn(B, 1, H, 128)
    offsets = [0, 17, T - 129, T - 1]
    off = torch.tensor(offsets, dtype=torch.int32, device='cuda')
    if quantized:
        st = {'k': torch.zeros(B, H, T, 128, dtype=torch.int8, device='cuda'),
              'v': torch.zeros(B, H, T, 128, dtype=torch.int8, device='cuda'),
              'ks': torch.zeros(B, H, T, device='cuda'),
              'vs': torch.zeros(B, H, T, device='cuda')}
    else:
        st = {'k': randn(B, T, H, 128), 'v': randn(B, T, H, 128)}
    want = {n: t.clone() for n, t in st.items()}
    _kv_write(st, k, v, off)
    for b, o in enumerate(offsets):
        for name, x in (('k', k), ('v', v)):
            if quantized:
                codes, scales = kv_quantize(x[b:b + 1, 0])
                want[name][b, :, o] = codes[0]
                want[name + 's'][b, :, o] = scales[0]
            else:
                want[name][b, o] = x[b, 0]
    torch.cuda.synchronize()
    for name in st:
        assert torch.equal(st[name], want[name]), name


def test_greedy_server_on_the_card_matches_the_cpu():
    """A greedy server run of ragged, staggered requests (more than its
    slots) on a small bf16 model: on the card (kernels 1-4 on its path,
    kernel 4 at one row with per-row offsets every decode step) the
    tokens equal the same run on the CPU and the card's B=1 Generator."""
    import numpy as np

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.serving import GenerationServer
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    cfg = tiny_config(hidden_size=256, num_filters=256,
                      num_attention_heads=2, compute_dtype='bfloat16',
                      param_dtype='bfloat16')
    module = model_lib.random_init(cfg, torch.Generator(device='cuda')
                                   .manual_seed(0), 'cuda')
    tok = CharLevelTokenizer(512)
    prompts = ['ACGTACGTAGGCTTAC' * 9, 'TTGGCCAATTGGA' * 3, 'GATTACA' * 20,
               'CCGTAAGT' * 4, 'ACGT' * 33]
    lens = [12, 7, 9, 10, 8]

    def serve(m):
        server = GenerationServer(m, tok, max_slots=2, max_len=256,
                                  steps_per_sync=4, prompt_chunk=64)
        rids = [server.submit(prompt=p, num_tokens=n)
                for p, n in zip(prompts[:3], lens[:3])]
        server.step()
        rids += [server.submit(prompt=p, num_tokens=n)
                 for p, n in zip(prompts[3:], lens[3:])]
        results = server.run()
        return [results[r].token_ids for r in rids]

    card = EvoModel(cfg, module)
    _build.LAUNCHES.clear()
    got = serve(card)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['flash_attention_buffer'] > 0
    assert _build.LAUNCHES['rmsnorm'] > 0 and _build.LAUNCHES['fir_gate'] > 0
    cpu = EvoModel(cfg, module.to('cpu'))
    for g, w in zip(got, serve(cpu)):
        np.testing.assert_array_equal(g, w)
    module.to('cuda')
    gen = Generator(card, tok, top_k=1, temperature=0.0)
    for g, p, n in zip(got, prompts, lens):
        want, _, _ = gen.generate(
            input_ids=np.asarray(tok.tokenize(p))[None], num_tokens=n,
            prefill_segment_len=64)
        np.testing.assert_array_equal(g, want[0].cpu().numpy())


# -- speculative decoding -------------------------------------------------------

@pytest.mark.parametrize('kv_quant', ['none', 'int8'])
@pytest.mark.parametrize('gamma', [3, 8])
def test_greedy_speculative_on_the_card(gamma, kv_quant):
    """Greedy speculative decoding on a small bf16 model on the card, over
    a cache of unaligned length (T % 4 != 0, so the int8 cache's scale
    rows are not 16-byte aligned). The drafter proposes the card's own
    greedy Generator stream, so cycles accept in full and in part. Held
    against the card's own verify logits: every emitted token, accepted
    count and log-prob follows from the logits each call returned; each
    verify pass starts from the offset of what was emitted before it (a
    restored cache after a partial acceptance); and each call launched
    the kernels its length gives (kernel 4, or kernel 5's split at
    <= 4 rows and its mainloop above, at every resumed call)."""
    import numpy as np

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch import speculative as spec
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    cfg = tiny_config(hidden_size=256, num_filters=256,
                      num_attention_heads=2, compute_dtype='bfloat16',
                      param_dtype='bfloat16', kv_quant=kv_quant)
    model = EvoModel(cfg, model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda'))
    tok = CharLevelTokenizer(512)
    prompt, n = 'ACGTTGCAAGT' * 4, 24                    # P = 44
    P = len(prompt)
    stream, _, _ = Generator(model, tok, top_k=1, temperature=0.0).generate(
        input_ids=np.asarray(tok.tokenize(prompt))[None],
        num_tokens=n + gamma + 1)
    stream = stream[0].cpu().numpy()
    flip = [0]

    def propose(self, g):
        # the card's greedy stream, wrong at one place every third cycle
        pos = len(self.tokens) - P
        props = [int(t) for t in stream[pos:pos + g]]
        props += [props[-1] if props else 0] * (g - len(props))
        flip[0] += 1
        if flip[0] % 3 == 0:
            props[flip[0] % g] = (props[flip[0] % g] + 1) % 512
        return np.asarray(props, np.int32)

    calls = []

    class Recorder:
        def initialize_inference_params(self, b, t):
            return model.initialize_inference_params(b, t)

        def __call__(self, ids, inference_params_dict=None, **kw):
            offset = inference_params_dict['offset']
            before = dict(_build.LAUNCHES)
            logits, cache = model(ids, inference_params_dict, **kw)
            torch.cuda.synchronize()
            launched = {k: v - before.get(k, 0)
                        for k, v in _build.LAUNCHES.items()
                        if v != before.get(k, 0)}
            calls.append((np.asarray(ids), offset, kw, logits.float().cpu(),
                          launched))
            return logits, cache

    real = spec.NGramIndex.propose
    spec.NGramIndex.propose = propose
    try:
        toks, logps, stats = spec.generate_speculative(
            Recorder(), tok, prompt=prompt, num_tokens=n, gamma=gamma)
    finally:
        spec.NGramIndex.propose = real
    T = P + n + gamma + 2
    assert T % 4 != 0
    assert stats.device_calls == len(calls)
    assert 0 < stats.accepted < stats.proposed
    # replay every decision from the recorded logits
    ids0, off0, _, lg0, _ = calls[0]
    out = [int(lg0[0, -1].argmax())]
    want_lp = [float(torch.log_softmax(lg0[0, -1].double(), -1)[out[0]])]
    accepted, i = 0, 1
    while i < len(calls):
        x, offset, kw, lg, _ = calls[i]
        assert not kw['donate_cache'] and x.shape == (1, gamma + 1)
        assert offset == P + len(out) - 1 and x[0, 0] == out[-1]
        greedy = lg[0].argmax(-1).numpy()
        a = 0
        while a < gamma and x[0, a + 1] == greedy[a]:
            a += 1
        emitted = [int(t) for t in x[0, 1:a + 1]] + [int(greedy[a])]
        lsm = torch.log_softmax(lg[0].double(), -1)
        want_lp += [float(lsm[j, t]) for j, t in enumerate(emitted)]
        out += emitted
        accepted += a
        i += 1
        if a < gamma:                           # the replay
            xr, offr, kwr, _, _ = calls[i]
            assert kwr['donate_cache'] and offr == offset
            np.testing.assert_array_equal(xr, x[:, :a + 1])
            i += 1
    np.testing.assert_array_equal(toks, out[:n])
    assert accepted == stats.accepted
    np.testing.assert_allclose(logps, want_lp[:n], rtol=0, atol=1e-4)
    n_attn = len(cfg.attn_layer_idxs)
    n_hyena = cfg.num_layers - n_attn
    for x, offset, _, _, launched in calls:
        L = x.shape[1]
        want = {'rmsnorm': 2 * cfg.num_layers + 1}
        if offset == 0:
            want['flash_attention'] = n_attn
        elif kv_quant == 'none':
            want['flash_attention_buffer'] = n_attn
            if L <= SPLIT_MAX_ROWS_BF16:
                want['combine_partials'] = n_attn
        else:
            want['flash_attention_buffer_q8'] = n_attn
            if L <= 4:
                want['combine_partials'] = n_attn
        if L >= 3:
            want['fir_gate'] = n_hyena
        assert launched == want, (L, offset, launched)


# -- training: kernels 1-3 under autograd ----------------------------------------

def _scaled(got, want):
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got - want).abs()
                  / want.abs().maximum(rms).clamp(min=1e-30)).max())


@pytest.mark.parametrize('kernel', ['rmsnorm', 'fir_gate', 'flash_attention'])
@pytest.mark.parametrize('L', [77, 1000])
def test_kernel_gradient_is_the_plain_gradient(randn, kernel, L):
    """Under autograd the wrapper launches its kernel once and its backward
    (the plain version's gradient, recomputed from the saved inputs)
    launches nothing: the gradients equal autograd's through the plain
    forward on the same inputs, bit for bit, but attention's, whose row
    blocks' float32 sums are added in another order (one bf16 rounding
    step, 2^-7 of the larger of the value and its row's rms)."""
    if kernel == 'rmsnorm':
        inputs = (randn(2, L, 4096).requires_grad_(),
                  randn(4096).requires_grad_())
        fwd, plain = (lambda: rmsnorm(*inputs)), (lambda: rmsnorm_plain(
            *inputs))
        grad_out, limit = (randn(2, L, 4096),), 0.0
    elif kernel == 'fir_gate':
        inputs = (randn(2, L, 3, 256).requires_grad_(),
                  randn(3, 256, 3).requires_grad_(),
                  randn(3, 256).requires_grad_(),
                  randn(2, 3, 256, 2).requires_grad_(),
                  randn(3, 256).requires_grad_())

        def args():
            zl, w, b, tail, b_in = inputs
            return zl.permute(0, 2, 3, 1), w, b, tail, b_in
        fwd = lambda: fir_gate(*args())                       # noqa: E731
        plain = lambda: fir_gate_plain(*args())               # noqa: E731
        grad_out, limit = (randn(2, 256, L), randn(2, 256, L)), 0.0
    else:
        qkv = randn(2, L, 3, 4, 128).requires_grad_()
        inputs = (qkv,)
        fwd = lambda: flash_attention_causal(*qkv.unbind(2))  # noqa: E731
        plain = lambda: attention_plain(*qkv.unbind(2))       # noqa: E731
        grad_out, limit = (randn(2, L, 4, 128),), 2 ** -7
    _build.LAUNCHES.clear()
    out = fwd()
    assert dict(_build.LAUNCHES) == {kernel: 1}
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in out)
    got = torch.autograd.grad(out, inputs, grad_out)
    assert dict(_build.LAUNCHES) == {kernel: 1}
    ref = plain()
    want = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,),
                               inputs, grad_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _scaled(g, w) <= limit


def test_kernels_without_a_backward_refuse_grad(randn):
    from evo_tpu_torch.ops.hyena_mixer import hyena_mixer
    zl = randn(1, 128, 3, 256).requires_grad_()
    with pytest.raises(RuntimeError, match='no backward'):
        hyena_mixer(zl.permute(0, 2, 3, 1), randn(3, 256, 3), None,
                    torch.rand(256, 8, 2, device='cuda') * 0.5,
                    torch.randn(256, 8, 2, device='cuda'), randn(256),
                    chunk=64)


@pytest.mark.parametrize('remat', [False, True])
def test_train_step_on_the_card(remat):
    """A full and a LoRA train step of a small bf16 model: the launches of
    a forward (and of the blocks' recompute under remat), every gradient
    through the kernels within one bf16 rounding step's reach of the
    all-plain gradient (the plain versions in the layers' place; the
    yardstick is that gradient moved by one rounding step, 2^-8 of random
    sign, of layer 0's normed input), and the loss falling."""
    from evo_tpu_torch import lora, model as model_lib, training
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.layers import attention as att_layer
    from evo_tpu_torch.layers import hyena as hyena_layer
    from evo_tpu_torch.layers import norms
    cfg = tiny_config(hidden_size=256, num_filters=256, num_attention_heads=2,
                      compute_dtype='bfloat16', param_dtype='bfloat16',
                      remat=remat)
    model = model_lib.random_init(cfg, torch.Generator(device='cuda')
                                  .manual_seed(0), 'cuda')
    g = torch.Generator(device='cuda').manual_seed(1)
    ids = torch.randint(65, 85, (2, 200), device='cuda', generator=g)
    sign = torch.randint(0, 2, (1, 1, 256), device='cuda', generator=g)
    params = dict(model.named_parameters())

    def grads(nudge=False):
        hook = model.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype)) if nudge else None
        training.set_trainable(params.values(), True)
        training.next_token_loss(model, None, ids).backward()
        training.set_trainable(params.values(), False)
        if hook is not None:
            hook.remove()
        out = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return out

    _build.LAUNCHES.clear()
    got = grads()
    n = 2 if remat else 1
    assert dict(_build.LAUNCHES) == {'rmsnorm': 9 + 8 * (n - 1),
                                     'fir_gate': 3 * n, 'flash_attention': n}
    saved = (norms.rmsnorm, hyena_layer.fir_gate,
             att_layer.flash_attention_causal)
    norms.rmsnorm, hyena_layer.fir_gate, att_layer.flash_attention_causal = (
        rmsnorm_plain, fir_gate_plain, attention_plain)
    try:
        _build.LAUNCHES.clear()
        want, nudged = grads(), grads(nudge=True)
        assert not _build.LAUNCHES
    finally:
        (norms.rmsnorm, hyena_layer.fir_gate,
         att_layer.flash_attention_causal) = saved
    for name in params:
        ref = want[name].float()
        dist = (got[name].float() - ref).norm() / ref.norm()
        assert dist <= (nudged[name].float() - ref).norm() / ref.norm(), name

    opt = training.make_optimizer(learning_rate=1e-3)
    state = training.init_train_state(model, opt)
    step = training.make_train_step(model, opt)
    losses = []
    for _ in range(3):
        state, loss = step(state, ids)
        losses.append(float(loss))
    adapters = lora.init_lora(torch.Generator(device='cuda').manual_seed(2),
                              model, rank=4)
    lstate = lora.init_lora_train_state(adapters, opt)
    lstep = lora.make_lora_train_step(model, opt)
    _build.LAUNCHES.clear()
    for _ in range(3):
        lstate, loss = lstep(lstate, ids)
        losses.append(float(loss))
    assert dict(_build.LAUNCHES) == {'rmsnorm': 3 * (9 + 8 * (n - 1)),
                                     'fir_gate': 3 * 3 * n,
                                     'flash_attention': 3 * n}
    assert losses[2] < losses[0] and losses[5] < losses[3], losses


# the small bf16 config of the two-rank test: 4 heads of 128, so each of
# tp = 2 ranks runs the attention kernels at 2 heads and the Hyena
# kernels at 256 channels
TP_SMALL = dict(hidden_size=512, num_filters=512, num_attention_heads=4,
                compute_dtype='bfloat16', param_dtype='bfloat16')


def test_tp2_gloo_ranks_on_one_card(tmp_path):
    """Two ranks on cuda:0 over gloo (`tools/tp_smoke.py small`): the
    tp = 2 logits against the single process's on the card, both ranks
    bit-equal, each launching kernels 1-3 at its shard's shapes. The tp
    reduces round the row-parallel products in other places: 5 % of the
    logit range, as the other bf16 model checks here."""
    import os
    from pathlib import Path

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.parallel.distributed import launch_local
    cfg = tiny_config(**TP_SMALL)
    ids = torch.randint(0, 512, (2, 200),
                        generator=torch.Generator().manual_seed(0))
    torch.save({'config': TP_SMALL, 'ids': ids}, tmp_path / 'small_in.pt')
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent.parent))
    launch_local(['-m', 'evo_tpu_torch.tools.tp_smoke', 'small',
                  str(tmp_path)], 2, env=env, timeout=600)
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    want = model_lib.forward(module, ids.cuda()).cpu()
    got = [torch.load(tmp_path / f'small_logits_rank{r}.pt') for r in (0, 1)]
    assert torch.equal(got[0], got[1])
    assert (got[0] - want).abs().max() <= 0.05 * want.abs().max()
    import json
    launches = json.load(open(tmp_path / 'small_rank0.json'))['part'][
        'launches']
    assert launches == {'rmsnorm': 2 * cfg.num_layers + 1,
                        'fir_gate': cfg.num_layers - 1, 'flash_attention': 1}


def test_tp2_server_gloo_ranks_on_one_card(tmp_path):
    """Two ranks on cuda:0 over gloo as one tp = 2 `GenerationServer`
    (`tools/mesh_smoke.py small`): the greedy tokens of three ragged
    prompts on 2 slots equal to the single process's server on the card,
    both ranks alike, kernel 4 launched at each rank's 2 heads."""
    import json
    import os
    from pathlib import Path

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.parallel.distributed import launch_local
    from evo_tpu_torch.serving import serve_requests
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    cfg = tiny_config(**TP_SMALL)
    prompts = ['ACGT' * 10, 'TTGACCA' * 9, 'GATTACA' * 3]
    torch.save({'config': TP_SMALL, 'prompts': prompts, 'num_tokens': 8},
               tmp_path / 'small_in.pt')
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent.parent))
    launch_local(['-m', 'evo_tpu_torch.tools.mesh_smoke', 'small',
                  str(tmp_path)], 2, env=env, timeout=600)
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    want = [r.token_ids.tolist() for r in serve_requests(
        EvoModel(cfg, module), CharLevelTokenizer(512), prompts,
        num_tokens=8, max_slots=2, steps_per_sync=4)]
    got = [json.load(open(tmp_path / f'small_rank{r}.json'))['part']
           for r in (0, 1)]
    assert got[0]['tokens'] == got[1]['tokens'] == want
    assert got[0]['launches'] == got[1]['launches']
    assert got[0]['launches']['flash_attention_buffer'] > 0


def _ulysses_layout(randn, B, L, cp=2, heads=16):
    """What the all-to-all over cp hands the attention layer: the received
    (cp, B, L/cp, 3, heads, 128) buffer viewed as (B, L, 3, heads, 128),
    as `collectives.seq_to_heads` returns it (a view at B = 1, a permuted
    copy above)."""
    recv = randn(cp, B, L // cp, 3, heads, 128)
    return recv.movedim(0, 1).flatten(1, 2)


@pytest.mark.parametrize('B,L,cut', [(1, 8192, 0), (2, 1000, 0), (1, 8194, 1),
                                     (2, 130, 1)])
def test_flash_attention_kernel_on_the_ulysses_layout(randn, B, L, cut):
    """Kernel 3 reads q, k, v where the all-to-all left them, also cut to
    the real positions of a padded sequence (`cut` rows fewer), against
    its plain version; kernel 4 over a cache written from that layout."""
    qkv = _ulysses_layout(randn, B, L)[:, :L - cut]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = _build.LAUNCHES['flash_attention']
    got = flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['flash_attention'] == before + 1
    assert got.shape == q.shape
    assert _scaled_err(got, attention_plain(q, k, v)) <= 2 ** -5
    T, n = L + 64, (L - cut) // 2
    kb = torch.zeros(B, T, 16, 128, dtype=torch.bfloat16, device='cuda')
    vb = torch.zeros_like(kb)
    kb[:, :L - cut], vb[:, :L - cut] = k, v
    got = flash_attention_buffer(q[:, n:], kb, vb, n)
    torch.cuda.synchronize()
    want = attention_buffer_plain(q[:, n:], kb, vb, n)
    assert _scaled_err(got, want) <= 2 ** -5


# the small bf16 config of the cp = 2 test: 4 heads of 128, so each rank
# runs kernel 3 at 2 heads and the Hyena kernels at 256 channels over the
# whole sequence
def test_cp2_gloo_ranks_on_one_card(tmp_path):
    """Two ranks on cuda:0 over gloo as one cp = 2 mesh (`tools/cp_smoke.py
    small`): the logits under each cp_attn against the single process's on
    the card, both ranks bit-equal, and under Ulysses at an odd length too
    (padded inside the model; the rings refuse it); kernel 3 at the Ulysses
    heads, and never in the rings' plain core."""
    import json
    import os
    from pathlib import Path

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.parallel.distributed import launch_local
    cfg = tiny_config(**TP_SMALL)
    ids = torch.randint(0, 512, (2, 200),
                        generator=torch.Generator().manual_seed(0))
    torch.save({'config': TP_SMALL, 'ids': ids}, tmp_path / 'small_in.pt')
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent.parent))
    launch_local(['-m', 'evo_tpu_torch.tools.cp_smoke', 'small',
                  str(tmp_path)], 2, env=env, timeout=600)
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    want = model_lib.forward(module, ids.cuda()).cpu()
    launches = json.load(open(tmp_path / 'small_rank0.json'))['part']
    for mode in ('ulysses', 'ring', 'zigzag'):
        got = [torch.load(tmp_path / f'small_{mode}_rank{r}.pt')
               for r in (0, 1)]
        assert torch.equal(got[0], got[1]), mode
        assert (got[0] - want).abs().max() <= 0.05 * want.abs().max(), mode
        assert launches[mode] == dict(
            {'rmsnorm': 2 * cfg.num_layers + 1,
             'fir_gate': cfg.num_layers - 1},
            **({'flash_attention': 1} if mode == 'ulysses' else {})), mode
    got = [torch.load(tmp_path / f'small_ragged_rank{r}.pt') for r in (0, 1)]
    assert torch.equal(got[0], got[1]) and got[0].shape[1] == 199
    assert (got[0] - want[:, :199]).abs().max() <= 0.05 * want.abs().max()


def test_cp2_train_step_gloo_ranks_on_one_card(tmp_path):
    """Two ranks on cuda:0 over gloo as one cp = 2 mesh (`tools/
    cp_train_smoke.py small`), one sharded train step of a small bf16
    model under 'ulysses' and under 'zigzag', B = 2, L = 200, against the
    single process in the ranks' arithmetic (for 'zigzag' the plain
    float32 attention in kernel 3's place, as the zigzag's core is): the
    first loss within one rounding step's yardstick (one extra bf16
    rounding, 2^-8 of random sign, on the output of layer 0's first norm:
    the RMS of the loss's move over four draws of the sign, since one
    draw can be far below the scale), every gradient as the step sums it
    within the larger of that yardstick's RMS relative distance and one
    bf16 rounding step of the gradient itself (2^-8: each rank's bf16
    gradient is a partial sum, rounded before the float32 sum over cp),
    both ranks' gradients bit-equal, and the launches of kernels 1-3
    under grad (kernel 3 at the Ulysses heads, never in the zigzag's
    plain core)."""
    import os
    from pathlib import Path

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch import training
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.layers import attention
    from evo_tpu_torch.parallel.distributed import launch_local
    cfg = tiny_config(**TP_SMALL)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 512, (2, 200), generator=gen)
    mask = (torch.rand((2, 200), generator=gen) < 0.8).float()
    torch.save({'config': TP_SMALL, 'ids': ids, 'mask': mask},
               tmp_path / 'small_in.pt')
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent.parent))
    launch_local(['-m', 'evo_tpu_torch.tools.cp_train_smoke', 'small',
                  str(tmp_path)], 2, env=env, timeout=600)
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    params = dict(module.named_parameters())

    def loss_and_grads(seed, core):
        sign = None if seed is None else torch.randint(
            0, 2, (1, 1, cfg.hidden_size), device='cuda',
            generator=torch.Generator('cuda').manual_seed(seed))
        hook = module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype)) if sign is not None else None
        real, attention.flash_attention_causal = (
            attention.flash_attention_causal, core)
        training.set_trainable(params.values(), True)
        try:
            loss = training.next_token_loss(module, training.train_config(
                module), ids, mask)
            loss.backward()
        finally:
            attention.flash_attention_causal = real
            training.set_trainable(params.values(), False)
        if hook is not None:
            hook.remove()
        grads = {n: p.grad.float() for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return float(loss.detach()), grads
    for mode, core in (('ulysses', attention.flash_attention_causal),
                       ('zigzag', attention_plain)):
        want_loss, want = loss_and_grads(None, core)
        nudged = [loss_and_grads(seed, core) for seed in (5, 6, 7, 8)]

        def rms(xs):
            return (sum(x * x for x in xs) / len(xs)) ** 0.5
        got = [torch.load(tmp_path / f'small_{mode}_rank{r}.pt')
               for r in (0, 1)]
        assert got[0]['loss'] == got[1]['loss']
        yard = rms([loss - want_loss for loss, _ in nudged])
        assert abs(got[0]['loss'] - want_loss) <= yard, (
            mode, got[0]['loss'], want_loss, yard)
        for n, w in want.items():
            g = got[0]['grads'][n].cuda()
            assert torch.equal(got[1]['grads'][n].cuda(), g), (mode, n)
            dist = float((g - w).norm() / w.norm())
            yard = max(rms([float((moved[n] - w).norm() / w.norm())
                            for _, moved in nudged]), 2.0 ** -8)
            assert dist <= yard, (mode, n, dist, yard)
        assert got[0]['launches'] == dict(
            {'rmsnorm': 2 * cfg.num_layers + 1,
             'fir_gate': cfg.num_layers - 1},
            **({'flash_attention': 1} if mode == 'ulysses' else {})), mode


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """More local ranks than cards under NCCL raise before NCCL does, and
    name the gloo backend; nothing switches backends quietly."""
    from evo_tpu_torch.parallel import distributed
    n = torch.cuda.device_count() + 1
    for k, v in dict(WORLD_SIZE=n, RANK=0, LOCAL_RANK=0, LOCAL_WORLD_SIZE=n,
                     MASTER_ADDR='localhost', MASTER_PORT=29999).items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(RuntimeError, match='--dist-backend gloo'):
        distributed.initialize_distributed(backend='nccl', device='cuda')
    with pytest.raises(RuntimeError, match='--dist-backend gloo'):
        distributed.initialize_distributed(device='cuda')


# -- float32 weights (param_dtype float32 under bf16 activations) ------------

def _f32(*shape, seed=1, scale=1.0):
    """float32 values that are not bf16 ones: a kernel must read them as
    stored."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    return torch.randn(*shape, device='cuda', generator=g) * scale


@pytest.mark.parametrize('rows,D', [(1, 4096), (5, 64), (8192, 4096)])
def test_rmsnorm_kernel_with_a_float32_gain(randn, rows, D):
    """Kernel 1 reads a float32 gain as stored (its own counter), within the
    bf16 gain's limit of its plain version, and differs from the kernel on
    the gain rounded to bf16."""
    x, w = randn(rows, D), _f32(D)
    before = _build.LAUNCHES['rmsnorm_w32']
    got = rmsnorm(x, w)
    assert _build.LAUNCHES['rmsnorm_w32'] == before + 1
    want = rmsnorm_plain(x, w)
    assert got.dtype == torch.bfloat16
    assert ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1)).max() <= 1e-2
    if rows * D >= 4096:
        assert not torch.equal(got, rmsnorm(x, w.bfloat16()))


@pytest.mark.parametrize('B,C,L', [(1, 64, 1), (2, 40, 77), (1, 2048, 300),
                                   (1, 4096, 64)])
def test_fir_gate_kernel_with_float32_taps(randn, B, C, L):
    """Kernel 2 with float32 taps and FIR bias (b_in and the tail bf16):
    bit-equal to its plain version, fresh and carried."""
    zl = randn(B, L, 3, C)
    w, fb, b_in = _f32(3, C, 3), _f32(3, C, seed=2), randn(3, C)
    for tail in (None, randn(B, 3, C, 2)):
        before = _build.LAUNCHES['fir_gate_w32']
        got = fir_gate(_in_place(zl), w, fb, tail, b_in=b_in)
        assert _build.LAUNCHES['fir_gate_w32'] == before + 1
        want = fir_gate_plain(_in_place(zl), w, fb, tail, b_in=b_in)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match='one type'):
        fir_gate(_in_place(zl), w, fb.bfloat16(), b_in=b_in)


@pytest.mark.parametrize('B,C,L,carried', [(1, 64, 128, False),
                                           (2, 40, 37, True),
                                           (1, 2048, 512, True)])
def test_hyena_mixer_kernel_with_float32_weights(randn, B, C, L, carried):
    """Kernel 6 with float32 taps, FIR bias and d_skip (b_in and the FIR
    tail bf16), under its bf16 limits: 2^-6 scaled, 99 % equal, the state
    within 1e-4, the FIR tail equal."""
    from evo_tpu_torch.ops.hyena_mixer import hyena_mixer, hyena_mixer_plain
    poles, residues = _modal(C, 8)
    z, b_in = _in_place(randn(B, L, 3, C)), randn(3, C)
    w, fb, d = _f32(3, C, 3, scale=0.5), _f32(3, C, seed=2, scale=0.1), \
        _f32(C, seed=3)
    st = (randn(B, 3, C, 2), randn(B, C, 8, 2).float()) if carried else None
    before = _build.LAUNCHES['hyena_mixer_w32']
    y, iir, fir = hyena_mixer(z, w, fb, poles, residues, d, chunk=64,
                              state=st, b_in=b_in)
    assert _build.LAUNCHES['hyena_mixer_w32'] == before + 1
    y_w, iir_w, fir_w = hyena_mixer_plain(z, w, fb, poles, residues, d,
                                          chunk=64, state=st, b_in=b_in)
    assert torch.equal(fir, fir_w)
    rms = y_w.float().pow(2).mean(-1, keepdim=True).sqrt()
    assert ((y.float() - y_w.float()).abs()
            / y_w.float().abs().maximum(rms)).max() <= 2 ** -6
    assert (y == y_w).float().mean() >= 0.99
    srms = iir_w.flatten(2).pow(2).mean(-1, keepdim=True).sqrt()
    assert ((iir.flatten(2) - iir_w.flatten(2)).abs()
            / iir_w.flatten(2).abs().maximum(srms)).max() <= 1e-4


@pytest.mark.parametrize('M,Kp,N', [(1, 4096, 12288), (2, 11008, 4096),
                                    (128, 4096, 4096), (3, 256, 40)])
def test_int4_function_gradient(M, Kp, N):
    """Kernel 8 under autograd: its Function's forward is the kernel
    (counted as 'int4_matmul_grad'), its backward the plain version's
    gradient to x, against autograd's through the plain version within
    kernel 8's limit (1e-4 of the larger of the value and its row's rms;
    the recomputed product sums in another order)."""
    x0, packed, s = _int4_case(M, Kp, N, seed=M)
    x = x0[:, :Kp - 17].contiguous().requires_grad_()
    g = torch.Generator(device='cuda').manual_seed(1)
    gy = torch.randn(M, N, device='cuda', generator=g).bfloat16()
    before = dict(_build.LAUNCHES)
    y = int4_matmul(x, packed, s, torch.bfloat16)
    assert _build.LAUNCHES['int4_matmul_grad'] == \
        before.get('int4_matmul_grad', 0) + 1
    assert _build.LAUNCHES['int4_matmul'] == before.get('int4_matmul', 0)
    (gx,) = torch.autograd.grad(y, x, gy)
    x2 = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(int4_matmul_plain(x2, packed, s,
                                                    torch.bfloat16), x2, gy)
    assert gx.dtype == torch.bfloat16 and gx.shape == x.shape
    gx, want = gx.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    assert ((gx - want).abs() / want.abs().maximum(rms)).max() <= 1e-4
    assert packed.grad is None and s.grad is None
