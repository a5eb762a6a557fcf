"""The yardstick's arithmetic: the card's published peaks, the least time
each of the port's kernels could take at a given shape, and the model
FLOPs a position costs.

A bound is the larger of the operations over the peak rate and the bytes
over the memory rate, counting each input byte read once and each output
byte written once (the arithmetic of `chip_smoke.py` and the
`evo_tpu_torch/tools/time_*.py` scripts, copied here so that a later
change to the program's copy does not move the benchmark). Every function
returns seconds and names the bound that applies.

Plain Python: nothing here imports torch, so the readers and the tests
use it anywhere.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM5 80 GB, data sheet, dense rates at the 700 W limit
H100_SXM = dict(bytes_s=3.35e12, bf16=989e12, fp32=67e12, int8=1979e12)

BF16 = 2


def peaks_for(device_name: str) -> dict:
    """The peak rates of the named card; any card other than the H100
    SXM (HBM3) raises, since no other card's bounds are kept here."""
    if 'H100' in device_name and 'HBM3' in device_name:
        return H100_SXM
    raise RuntimeError(f'no peak rates known for {device_name!r}: the '
                       'bounds are those of an H100 SXM')


def _bound(nbytes: float, ops: float, ops_rate: float,
           peaks: dict) -> Tuple[float, str]:
    t_bytes = nbytes / peaks['bytes_s']
    t_ops = ops / ops_rate
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def rmsnorm_bound(rows: int, dim: int, peaks: dict = H100_SXM
                  ) -> Tuple[float, str]:
    """Kernel 1: bf16 rows in and out, the bf16 gain once; 4 float32
    operations an element."""
    return _bound((2 * rows * dim + dim) * BF16, 4 * rows * dim,
                  peaks['fp32'], peaks)


def fir_gate_bound(rows: int, channels: int, peaks: dict = H100_SXM
                   ) -> Tuple[float, str]:
    """Kernel 2 over `rows` = B * L positions: the in-projection's (rows,
    3, C) bf16 output read, x2 and u (rows, C) written, and in bf16 `b_in`
    (3, C), the taps (3, C, 3) and the FIR bias (3, C); 25 float32
    operations a (row, channel)."""
    n_in = rows * 3 * channels
    nbytes = (n_in + 2 * n_in // 3 + 3 * channels + 9 * channels
              + 3 * channels) * BF16
    return _bound(nbytes, 25 * rows * channels, peaks['fp32'], peaks)


def attention_flops(heads: int, head_dim: int, lq: int,
                    offsets: Iterable[int]) -> int:
    """Causal attention for one batch row per entry of `offsets`: query
    row r at offset o attends the o + r + 1 keys up to its own position,
    and each (row, key) pair costs two products (Q K^T and P V) of 2
    operations a multiply-add over the head. Kernel 3 is offset 0."""
    return sum(4 * heads * head_dim * (lq * o + lq * (lq + 1) // 2)
               for o in offsets)


def attention_buffer_bound(lq: int, offset: int, heads: int = 32,
                           head_dim: int = 128, peaks: dict = H100_SXM
                           ) -> Tuple[float, str]:
    """Kernel 4 for one batch row: lq query rows at `offset` over a bf16
    KV buffer. Bytes: q and the output, and K and V of the live prefix
    [0, offset + lq); operations: `attention_flops`."""
    nbytes = (2 * (offset + lq) + 2 * lq) * heads * head_dim * BF16
    return _bound(nbytes, attention_flops(heads, head_dim, lq, [offset]),
                  peaks['bf16'], peaks)


def gemm_bound(m: int, k: int, n: int, peaks: dict = H100_SXM
               ) -> Tuple[float, str]:
    """One bf16 (m, k) x (k, n) product: both operands read once and the
    result written once, 2 m k n operations at the tensor cores' rate."""
    return _bound((m * k + k * n + m * n) * BF16, 2 * m * k * n,
                  peaks['bf16'], peaks)


def projection_shapes(cfg: dict):
    """The (k, n) of every bf16 projection of one forward position, layer
    by layer: a Hyena layer's in- and out-projections, an attention
    layer's QKV and output projections, and every layer's three MLP
    weights. The unembedding (a float32 product in the port) is not a
    bf16 projection and is left out."""
    D = cfg['hidden_size']
    inner = inner_mlp_size(cfg)
    shapes = []
    # a Hyena layer's in- and out-projections have the shapes of an
    # attention layer's QKV and output projections
    per_layer = [(D, 3 * D), (D, D), (D, inner), (D, inner), (inner, D)]
    return per_layer * cfg['num_layers']


def inner_mlp_size(cfg: dict) -> int:
    """The GLU width: the config's, or 2/3 of 4 D rounded up to
    `inner_size_multiple_of` (4,096 -> 10,928)."""
    if cfg.get('inner_mlp_size'):
        return cfg['inner_mlp_size']
    m = cfg.get('inner_size_multiple_of', 16)
    x = int(2 * cfg['hidden_size'] * 4 / 3)
    return -(-x // m) * m


def projections_bound(rows: int, cfg: dict, peaks: dict = H100_SXM
                      ) -> float:
    """Seconds: the sum over every bf16 projection of one pass over
    `rows` positions of its own bound (a decode step's products are
    bound by their weight bytes, a long forward's by operations)."""
    return sum(gemm_bound(rows, k, n, peaks)[0]
               for k, n in projection_shapes(cfg))


def projection_flops(rows: int, cfg: dict) -> int:
    return sum(2 * rows * k * n for k, n in projection_shapes(cfg))


def matmul_params(cfg: dict) -> int:
    """Weights of every product a position goes through: the projections
    of each layer and the unembedding (vocab x D)."""
    return (sum(k * n for k, n in projection_shapes(cfg))
            + cfg['vocab_size'] * cfg['hidden_size'])


def sequence_flops(cfg: dict, length: int, start: int = 0) -> int:
    """Model FLOPs of positions [start, start + length) of one sequence,
    position t attending its t + 1 keys: 2 operations a multiply-add of
    every matmul weight, and in each attention layer the score and value
    products over the position's context (`attention_flops`). The Hyena
    long convolution and every elementwise pass are left out."""
    H = cfg['num_attention_heads']
    Dh = cfg['hidden_size'] // H
    n_attn = len(cfg['attn_layer_idxs'])
    keys = (length * (2 * start + length + 1)) // 2
    return 2 * matmul_params(cfg) * length + n_attn * 4 * H * Dh * keys
