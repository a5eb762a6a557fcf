"""The yardsticks `chip_smoke.py` holds kernels 3 and 4 against, checked on
the CPU: the operation count behind both kernels' bounds, and the one
PyTorch call that computes kernel 4's function (SDPA under the
lower-right causal bias over the live prefix of the buffer), against the
port's plain versions in float32."""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right

import chip_smoke
from evo_tpu_torch.ops.attention import attention_plain
from evo_tpu_torch.ops.attention_buffer import attention_buffer_plain

torch.set_num_threads(2)


@pytest.mark.parametrize('heads,head_dim,lq,offsets', [
    (1, 1, 1, [0]),
    (2, 4, 5, [0]),              # kernel 3: the causal triangle
    (1, 8, 7, [3]),              # an unaligned offset
    (3, 2, 9, [5, 13]),          # one offset a batch row
    (1, 128, 40, [200]),
    (2, 16, 1, [0, 777]),        # one query row (decode)
    (1, 4, 130, [127, 128]),     # rows across a 128-key tile
])
def test_attention_flops_counts_unmasked_pairs(heads, head_dim, lq, offsets):
    pairs = 0
    for o in offsets:
        T = o + lq + 3               # keys past the last row never count
        pairs += sum(c <= o + r for r, c in itertools.product(range(lq),
                                                              range(T)))
    # two products (Q K^T, P V), 2 operations a multiply-add over the head
    assert chip_smoke.attention_flops(heads, head_dim, lq, offsets) \
        == 4 * heads * head_dim * pairs


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize('B,Lq,offset,T', [
    (1, 40, 200, 300),
    (2, 5, 0, 8),                # a fresh segment
    (1, 1, 99, 100),             # one query row at the buffer's last slot
    (2, 17, 31, 64),             # the segment fills the buffer to the brim
    (1, 64, 64, 130),
])
def test_sdpa_lower_right_is_the_buffer_function(B, Lq, offset, T):
    rng = np.random.default_rng(Lq + offset)
    q = _randn(rng, B, Lq, 2, 16)
    kb, vb = _randn(rng, B, T, 2, 16), _randn(rng, B, T, 2, 16)
    kb[:, offset + Lq:] *= 10        # past the live prefix: never attended
    vb[:, offset + Lq:] *= 10
    got = chip_smoke.sdpa_over_live_prefix(q, kb, vb, offset).transpose(1, 2)
    want = attention_buffer_plain(q, kb, vb, offset)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize('L', [1, 7, 33])
def test_causal_lower_right_square_is_causal(L):
    rng = np.random.default_rng(L)
    q, k, v = (_randn(rng, 2, L, 3, 8) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=causal_lower_right(L, L)).transpose(1, 2)
    assert float((got - attention_plain(q, k, v)).abs().max()) <= 1e-5
