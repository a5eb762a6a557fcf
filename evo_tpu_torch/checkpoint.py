"""The weight bridge: a reference-named state dict <-> the port's modules
(port of `evo_tpu/checkpoint.py:convert_state_dict` and its inverse
`export_state_dict`).

The state dict uses the engine's tensor names and torch layouts ((out, in)
Linear weights, (3D, 1, K) conv1d filters, (D, S, 1, 2) poles/residues),
which is what `evo_tpu.checkpoint.export_state_dict` emits and what HF
snapshots hold. Reading safetensors snapshots from disk is not ported yet.

Three layout assumptions could not be pinned to engine source and are
carried over unchanged from the JAX package (`RECONSTRUCTED_LAYOUTS`).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Union

import numpy as np
import torch

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.model import AttentionBlock, StripedHyena

RECONSTRUCTED_LAYOUTS = {
    'hyena_stream_order':
        "projections.weight rows split as x2|x1|v ([0:D | D:2D | 2D:3D])",
    'qkv_interleave':
        "Wqkv.weight (3D, D) reshaped as (D, 3, H, Dh) after transpose: "
        "q/k/v blocks contiguous in the output dim, heads minor",
    'poles_layout':
        "filter.poles/residues (D, S, 1, 2): trailing dim (real, imag), "
        "the broadcast axis squeezed at conversion",
}

# engine buffers present in snapshots that are not parameters
_BUFFER_RE = re.compile(r'rotary_emb\.inv_freq$|\.t$|filter\.h$')

Array = Union[np.ndarray, torch.Tensor]


def _as_tensor(a: Array) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which `torch.from_numpy`
    rejects: its bits are viewed as uint16) or torch -> torch tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.require(a, requirements=['C', 'W'])
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pop(sd: Dict[str, Array], key: str,
         required: bool = True) -> Optional[torch.Tensor]:
    if key in sd:
        return _as_tensor(sd.pop(key))
    if required:
        raise KeyError(f'checkpoint missing tensor {key!r}; '
                       f'remaining keys: {sorted(sd)[:8]}...')
    return None


def params_from_state_dict(sd: Dict[str, Array], cfg: ModelConfig,
                           device: Union[str, torch.device] = 'cuda'
                           ) -> StripedHyena:
    """Build the port's model from a reference-named state dict (backbone
    prefix already stripped). Every tensor must be consumed."""
    sd = {k: v for k, v in sd.items() if not _BUFFER_RE.search(k)}
    model = StripedHyena(cfg, device)
    D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim

    emb = _pop(sd, 'embedding_layer.weight')
    model.embedding.copy_(emb)
    unembed = _pop(sd, 'unembed.weight', required=False)
    if cfg.tie_embeddings:
        if unembed is not None and not torch.equal(unembed.float(),
                                                    emb.float()):
            raise ValueError(
                'checkpoint has an unembed.weight that differs from '
                'embedding_layer.weight but the config says '
                'tie_embeddings=True: untied snapshot, fix the config')
    else:
        model.unembed.copy_(unembed if unembed is not None else emb)
    if cfg.final_norm:
        model.final_norm.weight.copy_(_pop(sd, 'norm.scale'))

    def optional(key, enabled, dest, shape):
        b = _pop(sd, key, required=enabled)
        if b is not None and enabled:
            dest.copy_(b.reshape(shape))

    for i, blk in enumerate(model.blocks):
        p = f'blocks.{i}.'
        blk.pre_norm.weight.copy_(_pop(sd, p + 'pre_norm.scale'))
        blk.post_norm.weight.copy_(_pop(sd, p + 'post_norm.scale'))
        blk.mlp.w1.copy_(_pop(sd, p + 'mlp.l1.weight').T)
        blk.mlp.w2.copy_(_pop(sd, p + 'mlp.l2.weight').T)
        blk.mlp.w3.copy_(_pop(sd, p + 'mlp.l3.weight').T)
        if isinstance(blk, AttentionBlock):
            a = blk.attn
            a.wqkv.copy_(_pop(sd, p + 'inner_mha_cls.Wqkv.weight')
                         .T.reshape(D, 3, H, Dh))
            a.wo.copy_(_pop(sd, p + 'inner_mha_cls.out_proj.weight')
                       .T.reshape(H, Dh, D))
            optional(p + 'inner_mha_cls.Wqkv.bias', cfg.qkv_proj_bias,
                     a.bqkv, (3, H, Dh))
            optional(p + 'inner_mha_cls.out_proj.bias',
                     cfg.mha_out_proj_bias, a.bo, (D,))
            continue
        h = blk.hyena
        poles = _pop(sd, p + 'filter.poles')
        residues = _pop(sd, p + 'filter.residues')
        h.poles.copy_(poles.reshape(h.poles.shape))
        h.residues.copy_(residues.reshape(h.residues.shape))
        fir_w = _pop(sd, p + 'filter.short_filter_weight')
        h.fir_w.copy_(fir_w.reshape(h.fir_w.shape))
        h.w_in.copy_(_pop(sd, p + 'projections.weight').T.reshape(D, 3, D))
        h.d_skip.copy_(_pop(sd, p + 'filter.D'))
        h.w_out.copy_(_pop(sd, p + 'out_filter_dense.weight').T)
        optional(p + 'projections.bias', cfg.hyena_proj_bias, h.b_in, (3, D))
        optional(p + 'filter.short_filter_bias', cfg.short_filter_bias,
                 h.fir_b, (3, D))
        optional(p + 'out_filter_dense.bias', cfg.hyena_out_proj_bias,
                 h.b_out, (D,))
    if sd:
        raise ValueError(f'{len(sd)} unconsumed checkpoint tensors: '
                         f'{sorted(sd)[:10]}')
    return model


def state_dict(model: StripedHyena) -> Dict[str, torch.Tensor]:
    """Inverse of `params_from_state_dict`: reference names and torch
    layouts, contiguous CPU tensors in the parameters' own types (no
    non-parameter buffers)."""
    cfg = model.config
    D = cfg.hidden_size
    K = cfg.short_filter_length
    sd = {'embedding_layer.weight': model.embedding}
    if model.unembed is not None:
        sd['unembed.weight'] = model.unembed
    if model.final_norm is not None:
        sd['norm.scale'] = model.final_norm.weight
    for i, blk in enumerate(model.blocks):
        p = f'blocks.{i}.'
        sd[p + 'pre_norm.scale'] = blk.pre_norm.weight
        sd[p + 'post_norm.scale'] = blk.post_norm.weight
        sd[p + 'mlp.l1.weight'] = blk.mlp.w1.T
        sd[p + 'mlp.l2.weight'] = blk.mlp.w2.T
        sd[p + 'mlp.l3.weight'] = blk.mlp.w3.T
        if isinstance(blk, AttentionBlock):
            a = blk.attn
            sd[p + 'inner_mha_cls.Wqkv.weight'] = a.wqkv.reshape(D, -1).T
            sd[p + 'inner_mha_cls.out_proj.weight'] = a.wo.reshape(-1, D).T
            if a.bqkv is not None:
                sd[p + 'inner_mha_cls.Wqkv.bias'] = a.bqkv.reshape(-1)
            if a.bo is not None:
                sd[p + 'inner_mha_cls.out_proj.bias'] = a.bo
            continue
        h = blk.hyena
        sd[p + 'projections.weight'] = h.w_in.reshape(D, -1).T
        sd[p + 'filter.short_filter_weight'] = h.fir_w.reshape(-1, K)[:, None]
        sd[p + 'filter.poles'] = h.poles[:, :, None]
        sd[p + 'filter.residues'] = h.residues[:, :, None]
        sd[p + 'filter.D'] = h.d_skip
        sd[p + 'out_filter_dense.weight'] = h.w_out.T
        if h.b_in is not None:
            sd[p + 'projections.bias'] = h.b_in.reshape(-1)
        if h.fir_b is not None:
            sd[p + 'filter.short_filter_bias'] = h.fir_b.reshape(-1)
        if h.b_out is not None:
            sd[p + 'out_filter_dense.bias'] = h.b_out
    return {k: v.detach().to('cpu').contiguous() for k, v in sd.items()}
