"""Plain float32 StripedHyena (evo-1), the yardstick of every cell's
`correct`.

Written from the published architecture in plain PyTorch: no kernel,
cache, batching or segmenting, and nothing of `evo_tpu_torch` or of the
JAX package. It reads the weights by their reference (HF snapshot) names
in torch layouts, as the benchmark draws them, casts each layer's
weights to float32 when it reaches that layer, and runs one sequence in
one pass over its whole length, layer by layer. Positions are cut into
blocks only where an intermediate would not fit beside the bf16 model on
one card: the MLP, the attention's query rows, and the long
convolution's channels.

A block (pre-norm, residual):

    Hyena:     z = W_in h + b_in, streams x2 | x1 | v ([0:D | D:2D | 2D:3D])
               z = causal FIR of length K per channel, taps oldest first,
                   plus its bias
               u = x1 * v
               y = sum_tau h[t - tau] u[tau] + D_skip u,
                   h[t] = Re(sum_s R_s p_s^t)   (poles, residues (D, S, 2))
               out = W_out (x2 * y) + b_out
    Attention: q | k | v = W_qkv h + b (heads contiguous in each third),
               GPT-NeoX rotary on q and k at position t (t / factor under
               rotary interpolation), causal softmax(q k^T / sqrt(Dh)) v,
               out = W_o y + b_o
    MLP:       W_3 (gelu(W_1 h) * (W_2 h))          (exact-erf GELU)
    RMSNorm:   x / sqrt(mean(x^2) + eps) * scale

then a final RMSNorm and the tied unembedding (logits = x E^T).

The filter and the convolution run in float64 (by FFT), and the rotary
angles too, so that the reference's own rounding stays far below the
program's. Every float32 product runs at full float32 precision (TF32
off), set on entry and restored on return.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

MLP_ROWS = 16384          # positions of one MLP block
QUERY_ROWS = 4096         # query rows of one attention block
CONV_CHANNELS = 512       # channels of one long-convolution block


@contextlib.contextmanager
def full_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _w(sd: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return sd[name].float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def linear(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def causal_fir(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """z (L, C); w (C, K) taps oldest first; b (C,)."""
    K = w.shape[1]
    zp = F.pad(z, (0, 0, K - 1, 0))
    L = z.shape[0]
    y = b.expand_as(z).clone()
    for j in range(K):
        y += w[:, j] * zp[j:j + L]
    return y


def modal_filter(poles: torch.Tensor, residues: torch.Tensor, length: int
                 ) -> torch.Tensor:
    """h[c, t] = Re(sum_s R_s p_s^t), (C, length) float64."""
    p = torch.complex(poles[..., 0].double(), poles[..., 1].double())
    r = torch.complex(residues[..., 0].double(), residues[..., 1].double())
    t = torch.arange(length, dtype=torch.float64, device=poles.device)
    logp = torch.log(p)                               # (C, S)
    h = torch.zeros((p.shape[0], length), dtype=torch.float64,
                    device=poles.device)
    for s in range(p.shape[1]):
        h += torch.real(r[:, s:s + 1] * torch.exp(logp[:, s:s + 1] * t))
    return h


def long_conv(u: torch.Tensor, poles: torch.Tensor, residues: torch.Tensor,
              d_skip: torch.Tensor) -> torch.Tensor:
    """u (L, C) float32 -> y (L, C) float32: the causal convolution with
    the modal filter, by FFT of twice the length, plus D_skip u."""
    L, C = u.shape
    n = 1 << (2 * L - 1).bit_length()
    y = torch.empty_like(u)
    for c0 in range(0, C, CONV_CHANNELS):
        c1 = min(C, c0 + CONV_CHANNELS)
        h = modal_filter(poles[c0:c1], residues[c0:c1], L)
        uf = torch.fft.rfft(u[:, c0:c1].T.double(), n=n)
        conv = torch.fft.irfft(uf * torch.fft.rfft(h, n=n), n=n)[:, :L]
        y[:, c0:c1] = conv.T.float()
    return y + d_skip * u


def hyena(sd, p: str, h: torch.Tensor, cfg: dict) -> torch.Tensor:
    D = cfg['hidden_size']
    K = cfg['short_filter_length']
    w_in = _w(sd, p + 'projections.weight')
    b_in = _w(sd, p + 'projections.bias')
    fir_w = _w(sd, p + 'filter.short_filter_weight').reshape(3 * D, K)
    fir_b = _w(sd, p + 'filter.short_filter_bias')
    streams = []
    for s in range(3):
        rows = slice(s * D, (s + 1) * D)
        z = linear(h, w_in[rows], b_in[rows])
        streams.append(causal_fir(z, fir_w[rows], fir_b[rows]))
        del z
    x2, x1, v = streams
    u = x1 * v
    del x1, v, streams
    poles = _w(sd, p + 'filter.poles').reshape(D, -1, 2)
    residues = _w(sd, p + 'filter.residues').reshape(D, -1, 2)
    y = long_conv(u, poles, residues, _w(sd, p + 'filter.D'))
    del u
    return linear(x2 * y, _w(sd, p + 'out_filter_dense.weight'),
                  _w(sd, p + 'out_filter_dense.bias'))


def rotary(x: torch.Tensor, positions: torch.Tensor, cfg: dict
           ) -> torch.Tensor:
    """x (L, H, Dh), rotate-half, angles in float64."""
    half = x.shape[-1] // 2
    base = cfg.get('rotary_base', 10000.0)
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half))
    t = positions.double()
    if cfg.get('use_interpolated_rotary_pos_emb'):
        t = t / cfg['rotary_emb_scaling_factor']
    ang = t[:, None] * inv
    c = torch.cos(ang).float()[:, None, :]
    s = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(sd, p: str, h: torch.Tensor, cfg: dict) -> torch.Tensor:
    L, D = h.shape
    H = cfg['num_attention_heads']
    Dh = D // H
    w = _w(sd, p + 'inner_mha_cls.Wqkv.weight')
    b = _w(sd, p + 'inner_mha_cls.Wqkv.bias')
    pos = torch.arange(L, device=h.device)
    q, k, v = (linear(h, w[i * D:(i + 1) * D], b[i * D:(i + 1) * D])
               .reshape(L, H, Dh) for i in range(3))
    q, k = rotary(q, pos, cfg), rotary(k, pos, cfg)
    y = torch.empty_like(q)
    scale = 1.0 / math.sqrt(Dh)
    for hd in range(H):
        kh, vh = k[:, hd], v[:, hd]
        for r0 in range(0, L, QUERY_ROWS):
            r1 = min(L, r0 + QUERY_ROWS)
            s = (q[r0:r1, hd] @ kh[:r1].T) * scale
            row = torch.arange(r0, r1, device=h.device)[:, None]
            col = torch.arange(r1, device=h.device)[None, :]
            s.masked_fill_(col > row, float('-inf'))
            y[r0:r1, hd] = torch.softmax(s, dim=-1) @ vh[:r1]
            del s
    del q, k, v
    return linear(y.reshape(L, D), _w(sd, p + 'inner_mha_cls.out_proj.weight'),
                  _w(sd, p + 'inner_mha_cls.out_proj.bias'))


def mlp(sd, p: str, h: torch.Tensor) -> torch.Tensor:
    w1, w2, w3 = (_w(sd, p + f'mlp.l{i}.weight') for i in (1, 2, 3))
    out = torch.empty_like(h)
    for r0 in range(0, h.shape[0], MLP_ROWS):
        x = h[r0:r0 + MLP_ROWS]
        out[r0:r0 + MLP_ROWS] = linear(
            F.gelu(linear(x, w1)) * linear(x, w2), w3)
    return out


@torch.no_grad()
def logits(sd: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor
           ) -> torch.Tensor:
    """ids (L,) integer -> logits (L, vocab_size) float32 of one sequence,
    on the weights' device."""
    eps = cfg['eps']
    with full_float32():
        x = _w(sd, 'embedding_layer.weight')[ids.long()]
        for i in range(cfg['num_layers']):
            p = f'blocks.{i}.'
            h = rmsnorm(x, _w(sd, p + 'pre_norm.scale'), eps)
            if i in cfg['attn_layer_idxs']:
                x = x + attention(sd, p, h, cfg)
            else:
                x = x + hyena(sd, p, h, cfg)
            h = rmsnorm(x, _w(sd, p + 'post_norm.scale'), eps)
            x = x + mlp(sd, p, h)
            del h
        x = rmsnorm(x, _w(sd, 'norm.scale'), eps)
        out = x @ _w(sd, 'embedding_layer.weight').T
    return out[:, :cfg['vocab_size']]


def next_token_logprobs(sd, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """log p(ids[t + 1] | ids[:t + 1]) for t in [0, L - 1), float32."""
    lp = torch.log_softmax(logits(sd, cfg, ids), dim=-1)
    return lp[:-1].gather(-1, ids[1:, None].long())[:, 0]
