"""The plain versions behind the buffer kernels' split key range (int8
and bf16 buffers) and the card's decode route, against the one-pass plain
version and the JAX package's buffer kernel in interpret mode, on the CPU
in float32.

At few query rows the card splits the key range across blocks; each
writes the online-softmax state of its range (m, l, acc), and a combine
kernel merges them. `attention_buffer_partials_plain` and
`combine_partials_plain` are those two steps in plain PyTorch: in float32,
where rounding P to q's type changes nothing, merged partials equal the
one pass up to the order of float32 sums (1e-6). Each block sizes its
range from its row's offset on the device; `split_bounds` is that sizing
in plain Python, per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evo_tpu.ops.pallas_attention as jax_pallas_attention
from evo_tpu.layers import attention as jax_attn
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.layers import attention
from evo_tpu_torch.ops.attention_buffer import (
    SPLIT_BLOCKS_PER_SM_BF16, SPLIT_MIN_KEYS_BF16, SPLIT_STEP,
    attention_buffer_partials_plain, attention_buffer_plain,
    combine_partials, combine_partials_plain, key_splits, key_splits_bf16,
    split_bounds)

torch.set_num_threads(2)
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_torch_kvquant.py

# boundaries inside 64-key tiles; with the offsets below, the last
# ranges lie wholly past row 0's live prefix (keys 0..39)
BOUNDS = {1: [0, 256], 3: [0, 45, 131, 256],
          7: [0, 13, 40, 77, 129, 150, 211, 256]}
OFFSETS = (37, 200)


def _case(kind, rng, B=2, Lq=3, T=256, H=2, Dh=128):
    """(torch args after q, JAX args after q) of the buffer op: int8
    head-major codes and scales quantised by the JAX package, or
    bf16-valued buffers (float32 storage, so the sums stay float32)."""
    if kind == 'int8':
        t, j = [], []
        for _ in range(2):
            c, s = jax_attn.kv_quantize(jnp.asarray(
                rng.standard_normal((B, T, H, Dh)), jnp.float32))
            c, s = jnp.swapaxes(c, 1, 2), jnp.swapaxes(s, 1, 2)
            j += [c, s]
            t += [torch.from_numpy(np.array(c)),
                  torch.from_numpy(np.array(s))]
        return (t[0], t[2], t[1], t[3]), (j[0], j[2], j[1], j[3])
    bufs = [torch.from_numpy(rng.standard_normal((B, T, H, Dh)).astype(
        np.float32)).bfloat16().float() for _ in range(2)]
    return tuple(bufs), tuple(jnp.asarray(b.numpy()) for b in bufs)


@pytest.mark.parametrize('splits', [1, 3, 7])
@pytest.mark.parametrize('kind', ['int8', 'bf16'])
def test_partials_combine_to_one_pass(kind, splits):
    rng = np.random.default_rng(splits)
    B, Lq, H, Dh = 2, 3, 2, 128
    q = rng.standard_normal((B, Lq, H, Dh)).astype(np.float32)
    bufs_t, bufs_j = _case(kind, rng)
    off_t = torch.tensor(OFFSETS, dtype=torch.int32)
    q_t = torch.from_numpy(q)
    k, v, *scales = bufs_t
    m, l, acc = attention_buffer_partials_plain(q_t, k, v, off_t,
                                                BOUNDS[splits], *scales)
    S = splits
    assert m.shape == l.shape == (B, H, Lq, S)
    assert acc.shape == (B, H, Lq, S, Dh)
    past = [i for i, lo in enumerate(BOUNDS[splits][:-1])
            if lo > OFFSETS[0] + Lq - 1]
    assert len(past) == {1: 0, 3: 2, 7: 5}[splits]
    for i in past:              # wholly past row 0's prefix: drops out
        assert torch.isinf(m[0, :, :, i]).all() and not l[0, :, :, i].any()
        assert not acc[0, :, :, i].any()
    got = combine_partials_plain(m, l, acc, torch.float32)
    assert got.shape == (B, Lq, H, Dh) and got.is_contiguous()
    # the CPU wrapper takes the plain version
    assert torch.equal(combine_partials(m, l, acc, torch.float32), got)
    one = attention_buffer_plain(q_t, k, v, off_t, *scales)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **SPLIT_TOL)
    want = jax_pallas_attention.flash_attention_buffer(
        jnp.asarray(q), *bufs_j[:2], jnp.asarray(OFFSETS, jnp.int32),
        *bufs_j[2:], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_combine_of_empty_rows_and_rounding():
    """A row no partial covers gives zeros; the output is rounded once, to
    the requested type."""
    m = torch.tensor([[[[float('-inf'), float('-inf')],
                        [0.5, float('-inf')]]]])
    l = torch.tensor([[[[0.0, 0.0], [2.0, 0.0]]]])
    acc = torch.zeros(1, 1, 2, 2, 4)
    acc[0, 0, 1, 0] = torch.tensor([2.0, 4.0, 6.0, 1.0 / 3.0])
    got = combine_partials_plain(m, l, acc, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, 1, 4)
    assert not got[0, 0].any()
    assert torch.equal(got[0, 1, 0], torch.tensor(
        [1.0, 2.0, 3.0, 1.0 / 6.0]).bfloat16())


@pytest.mark.parametrize('n_keys,heads,sms', [
    (122880, 32, 132), (122880, 64, 132), (8192, 32, 132), (1, 32, 132),
    (1000, 2, 4), (65536, 4096, 132), (777, 64, 132)])
def test_key_splits_cover_the_range(n_keys, heads, sms):
    chunk, S = key_splits(n_keys, heads, sms)
    assert chunk % SPLIT_STEP == 0 and S >= 1
    assert (S - 1) * chunk < n_keys <= S * chunk
    assert heads * S <= max(4 * sms + heads, heads)
    # one wave: no more than four blocks an SM, as many as fit
    assert heads * S <= max(4 * sms, heads)
    assert S <= -(-n_keys // 512)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_dense_decode_step_is_the_buffer_function(dtype):
    """On the CPU `mha_step` attends an unquantised cache densely; on the
    card it calls the buffer kernel at one query row. Both compute
    `attention_buffer_plain`'s function: the step's output against that
    function on the same cache, within float32 sums (bf16: within one
    rounding of the attention output)."""
    rng = np.random.default_rng(3)
    D, H, B, T, offset = 256, 2, 2, 300, 217
    cfg = tiny_config(hidden_size=D, num_filters=D, num_attention_heads=H)
    p = attention.Attention(cfg, dtype=dtype, device='cpu')
    for name in ('wqkv', 'wo'):
        w = getattr(p, name)
        w.copy_(torch.from_numpy(rng.standard_normal(tuple(w.shape)).astype(
            np.float32) * 0.05))
    cache = {n: torch.from_numpy(rng.standard_normal((B, T, H, 128)).astype(
        np.float32)).to(dtype) for n in ('k', 'v')}
    x = torch.from_numpy(rng.standard_normal((B, 1, D)).astype(
        np.float32)).to(dtype)
    ref = {n: t.clone() for n, t in cache.items()}
    got, _ = attention.mha_step(p, cfg, x, cache, offset)
    q, k, v = attention._qkv(p, x)
    q, k = attention._rotate(cfg, q, k, offset)
    attention._kv_write(ref, k, v, offset)
    assert all(torch.equal(ref[n], cache[n]) for n in ref)
    want = attention._out(p, attention_buffer_plain(q, ref['k'], ref['v'],
                                                    offset))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


# -- the split sized on the device: per-row bounds -------------------------------

@pytest.mark.parametrize('live,S', [
    (1, 1), (1, 8), (18, 3), (64, 2), (65, 2), (300, 7), (1000, 8),
    (8192, 17), (8192, 8), (122880, 8), (131072, 17), (0, 4)])
def test_split_bounds_cover_the_live_prefix(live, S):
    """Each block's range as the kernels compute it from the offset:
    ceil(live / S) rounded up to SPLIT_STEP keys a range, the ranges in
    order and covering [0, live) exactly, every non-empty one but the last
    of the full chunk, the ones past the prefix empty at its end."""
    b = split_bounds(live, S)
    assert len(b) == S + 1 and b[0] == 0 and b[-1] == live
    assert all(lo <= hi for lo, hi in zip(b, b[1:]))
    chunk = -(-(-(-live // S)) // SPLIT_STEP) * SPLIT_STEP
    ranges = list(zip(b, b[1:]))
    full = [hi - lo for lo, hi in ranges if hi > lo]
    assert all(n == chunk for n in full[:-1])
    assert 0 < full[-1] <= chunk if live else not full
    assert all(lo == min(i * chunk, live) for i, (lo, _) in enumerate(ranges))
    # the empty ranges are the last ones, past the prefix
    n_live = len(full)
    assert all(lo == hi == live for lo, hi in ranges[n_live:])
    assert n_live == -(-live // chunk) if live else n_live == 0


@pytest.mark.parametrize('n_keys,heads,sms', [
    (131072, 32, 132), (122880, 32, 132), (8009, 32, 132), (1, 32, 132),
    (131072, 16, 132), (2048, 256, 132), (131072, 512, 132), (777, 4, 8)])
def test_key_splits_bf16_fill_one_wave(n_keys, heads, sms):
    """The bf16 split's S: at most one wave of blocks
    (SPLIT_BLOCKS_PER_SM_BF16 an SM) unless one range a (batch, head)
    already takes more, and no range under SPLIT_MIN_KEYS_BF16 keys
    beyond the first."""
    S = key_splits_bf16(n_keys, heads, sms)
    assert S >= 1
    assert heads * S <= max(SPLIT_BLOCKS_PER_SM_BF16 * sms, heads)
    assert S <= -(-n_keys // SPLIT_MIN_KEYS_BF16)
    # the ranges as the blocks compute them cover the keys
    b = split_bounds(n_keys, S)
    assert b[-1] == n_keys and len(b) == S + 1


@pytest.mark.parametrize('Lq', [1, 4, 9, 16])
@pytest.mark.parametrize('kind', ['int8', 'bf16'])
def test_device_sized_partials_combine_to_one_pass(kind, Lq):
    """(B,) offsets with one row near 0 and one at the end of the buffer,
    each row's ranges from its own live prefix (`split_bounds`, as the
    blocks size them on the device): the ranges past row 0's prefix are
    empty, and the merged partials equal the one-pass plain version
    (1e-6) and the JAX package's buffer kernel in interpret mode (2e-5)."""
    rng = np.random.default_rng(40 + Lq)
    B, H, Dh, T, S = 2, 2, 128, 256, 3
    offsets = (2, T - Lq)
    q = rng.standard_normal((B, Lq, H, Dh)).astype(np.float32)
    bufs_t, bufs_j = _case(kind, rng, B=B, Lq=Lq, T=T, H=H, Dh=Dh)
    k, v, *scales = bufs_t
    off_t = torch.tensor(offsets, dtype=torch.int32)
    q_t = torch.from_numpy(q)
    bounds = [split_bounds(min(o + Lq, T), S) for o in offsets]
    assert bounds[0][1] == bounds[0][-1] == 2 + Lq    # one live range
    assert bounds[1][-1] == T
    m, l, acc = attention_buffer_partials_plain(q_t, k, v, off_t, bounds,
                                                *scales)
    assert m.shape == l.shape == (B, H, Lq, S)
    assert acc.shape == (B, H, Lq, S, Dh)
    assert torch.isinf(m[0, :, :, 1:]).all() and not l[0, :, :, 1:].any()
    assert not acc[0, :, :, 1:].any()
    # row 1's 256 keys in ranges of 128 (ceil(256 / 3) rounded up to 64):
    # two full, the third empty
    assert bounds[1] == [0, 128, 256, 256]
    assert torch.isfinite(m[1, :, :, :2]).all() and torch.isinf(
        m[1, :, :, 2]).all()
    got = combine_partials_plain(m, l, acc, torch.float32)
    one = attention_buffer_plain(q_t, k, v, off_t, *scales)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **SPLIT_TOL)
    want = jax_pallas_attention.flash_attention_buffer(
        jnp.asarray(q), *bufs_j[:2], jnp.asarray(offsets, jnp.int32),
        *bufs_j[2:], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize('Lq,offsets', [(1, (0, 299)), (16, (5, 284)),
                                        (9, (100, 200))])
def test_device_sized_partials_at_a_ragged_length(Lq, offsets):
    """T = 300, not a multiple of the 64-key step, the one-wave S of a
    small card: per-row partials merged equal the one pass (1e-6)."""
    rng = np.random.default_rng(Lq)
    B, H, Dh, T = 2, 2, 128, 300
    (k, v), _ = _case('bf16', rng, B=B, Lq=Lq, T=T, H=H, Dh=Dh)
    q_t = torch.from_numpy(rng.standard_normal((B, Lq, H, Dh)).astype(
        np.float32))
    off_t = torch.tensor(offsets, dtype=torch.int32)
    S = key_splits_bf16(T, B * H, 4)
    bounds = [split_bounds(min(o + Lq, T), S) for o in offsets]
    got = combine_partials_plain(*attention_buffer_partials_plain(
        q_t, k, v, off_t, bounds), torch.float32)
    np.testing.assert_allclose(
        got.numpy(), attention_buffer_plain(q_t, k, v, off_t).numpy(),
        **SPLIT_TOL)


def test_per_row_bounds_need_one_list_a_row():
    q = torch.zeros(2, 1, 2, 128)
    buf = torch.zeros(2, 64, 2, 128)
    with pytest.raises(ValueError, match='lists of bounds'):
        attention_buffer_partials_plain(q, buf, buf, 0, [[0, 64]])
