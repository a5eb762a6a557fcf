"""The yardstick's bounds at the shapes of PERF.md's table of kernels,
and the model FLOPs against a hand count."""

import json
import os

import pytest

from benchmark import harness, roofline


def test_bounds_reproduce_the_kernel_table():
    ms = {
        'rmsnorm 8192 x 4096': roofline.rmsnorm_bound(8192, 4096),
        'fir_gate 1 x 8192': roofline.fir_gate_bound(8192, 4096),
        'kernel 4, Lq 8192 at 122,880': roofline.attention_buffer_bound(
            8192, 122880),
        'kernel 4, one row at 122,879': roofline.attention_buffer_bound(
            1, 122879),
    }
    assert round(1e3 * ms['rmsnorm 8192 x 4096'][0], 4) == 0.0401
    assert round(1e3 * ms['fir_gate 1 x 8192'][0], 4) == 0.1002
    assert round(1e3 * ms['kernel 4, Lq 8192 at 122,880'][0], 2) == 17.23
    assert round(1e3 * ms['kernel 4, one row at 122,879'][0], 3) == 0.601
    assert [b for _, b in ms.values()] == ['bytes', 'bytes', 'operations',
                                            'bytes']


def _cfg():
    with open(os.path.join(harness.HERE, 'configs',
                           'evo-1-8k-base.json')) as f:
        return json.load(f)['config']


def test_model_flops_at_8192_by_hand():
    cfg = _cfg()
    D, inner, V, L = 4096, 10928, 512, 8192
    per_layer = 3 * D * D + D * D + 3 * D * inner     # 201,392,128
    params = 32 * per_layer + V * D
    assert roofline.matmul_params(cfg) == params == 6_446_645_248
    # attention: 3 layers, 4 H Dh operations a (query, key) pair, and the
    # L (L + 1) / 2 pairs of a causal sequence
    attn = 3 * 4 * 4096 * (L * (L + 1) // 2)
    hand = 2 * params * L + attn
    assert hand == 107_271_304_511_488        # 13.09 GFLOP a position
    assert roofline.sequence_flops(cfg, L) == hand


def test_sequence_flops_from_an_offset_adds_up():
    cfg = _cfg()
    whole = roofline.sequence_flops(cfg, 1000)
    parts = (roofline.sequence_flops(cfg, 300)
             + roofline.sequence_flops(cfg, 700, start=300))
    assert whole == parts


def test_projection_bounds_follow_the_shapes():
    cfg = _cfg()
    # 160 bf16 products a position: 5 a layer
    assert len(roofline.projection_shapes(cfg)) == 160
    # a decode step's products are bound by their weights' bytes
    t, which = roofline.gemm_bound(64, 4096, 10928)
    assert which == 'bytes'
    # 12.9 GB of projection weights a step at 3.35 TB/s: ~3.85 ms
    assert 3.8e-3 < roofline.projections_bound(64, cfg) < 4.0e-3
    assert roofline.gemm_bound(65536, 4096, 10928)[1] == 'operations'


def test_only_the_h100_has_peaks():
    assert roofline.peaks_for('NVIDIA H100 80GB HBM3') is roofline.H100_SXM
    with pytest.raises(RuntimeError):
        roofline.peaks_for('NVIDIA A100-SXM4-80GB')
