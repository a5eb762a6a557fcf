"""Checkpoints of the port (port of `evo_tpu/checkpoint.py`).

Two formats on disk:

  * **Reference snapshot**: safetensors in the engine's tensor names and
    torch layouts ((out, in) Linear weights, (3D, 1, K) conv1d filters,
    (D, S, 1, 2) poles/residues), one `model.safetensors` or shards plus
    `model.safetensors.index.json`, keys under a `backbone.` prefix. This
    is what HF snapshots hold, what `evo_tpu.checkpoint` reads and writes,
    and so the format in which weights cross between the two packages.
  * **Native**: a directory with the same tensors (no prefix) as
    safetensors files plus the marker `evo_tpu_torch_checkpoint.json`,
    which holds the config the weights were saved under. It is the port's
    own: the JAX package's native format is an orbax directory, which the
    port does not read.

The safetensors files are read and written here, without the
`safetensors` package: an 8-byte little-endian header length, a JSON
header of `dtype` / `shape` / `data_offsets` per tensor, then the raw
little-endian data. A file is memory-mapped, and `params_from_state_dict`
copies one tensor at a time to the device, so a load never holds two full
copies of the weights.

Three layout assumptions could not be pinned to engine source and are
carried over unchanged from the JAX package (`RECONSTRUCTED_LAYOUTS`).

Stored weights are unquantized, as in the JAX package: quantization
happens after a load (`models.load_checkpoint`), and `state_dict` refuses
a quantized model. `quantized_layers_from_jax` sets the port's quantized
layers from a JAX quantized tree, so tests run both packages on the same
codes. `cache_from_jax` / `cache_to_jax` carry a decode cache across, so
either package can resume from a state the other produced, and
`lora_from_jax` / `lora_to_jax` carry LoRA adapters across.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.layers.hyena import HyenaState
from evo_tpu_torch.model import AttentionBlock, StripedHyena
from evo_tpu_torch.parallel.sharding import shard_tensor
from evo_tpu_torch.quant import QuantizedWeight

NATIVE_MARKER = 'evo_tpu_torch_checkpoint.json'
# the marker of the JAX package's native (orbax) format, named only to
# tell a user who points the port at such a directory what it is
_JAX_NATIVE_MARKER = 'evo_tpu_checkpoint.json'

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


def _pop(sd: Dict[str, Array], key: str, required: bool = True,
         device: Union[str, torch.device] = 'cpu'
         ) -> Optional[torch.Tensor]:
    """Take `key` out of `sd`, as a tensor on `device`: one tensor at a
    time crosses, and every transpose after it runs there."""
    if key in sd:
        return _as_tensor(sd.pop(key)).to(device)
    if required:
        raise KeyError(f'checkpoint missing tensor {key!r}; '
                       f'remaining keys: {sorted(sd)[:8]}...')
    return None


def params_from_state_dict(sd: Dict[str, Array], cfg: ModelConfig,
                           device: Union[str, torch.device] = 'cuda',
                           mesh=None) -> StripedHyena:
    """Build the port's model from a reference-named state dict (backbone
    prefix already stripped). Every tensor must be consumed. Under a mesh
    each tensor is read whole, its tp slice kept (`parallel.sharding`) and
    the rest freed before the next one is read."""
    sd = {k: v for k, v in sd.items() if not _BUFFER_RE.search(k)}
    model = StripedHyena(cfg, device, mesh)
    D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    names = {id(t): n for n, t in model.named_parameters()}

    def pop(key, required=True):
        return _pop(sd, key, required, model.device)

    def put(dest, full):
        dest.copy_(shard_tensor(full, names[id(dest)], mesh))

    emb = pop('embedding_layer.weight')
    put(model.embedding, emb)
    unembed = pop('unembed.weight', required=False)
    if cfg.tie_embeddings:
        if unembed is not None and not torch.equal(unembed.float(),
                                                    emb.float()):
            raise ValueError(
                'checkpoint has an unembed.weight that differs from '
                'embedding_layer.weight but the config says '
                'tie_embeddings=True: untied snapshot, fix the config')
    else:
        put(model.unembed, unembed if unembed is not None else emb)
    if cfg.final_norm:
        put(model.final_norm.weight, pop('norm.scale'))

    def optional(key, enabled, dest, shape):
        b = pop(key, required=enabled)
        if b is not None and enabled:
            put(dest, b.reshape(shape))

    for i, blk in enumerate(model.blocks):
        p = f'blocks.{i}.'
        put(blk.pre_norm.weight, pop(p + 'pre_norm.scale'))
        put(blk.post_norm.weight, pop(p + 'post_norm.scale'))
        put(blk.mlp.w1, pop(p + 'mlp.l1.weight').T)
        put(blk.mlp.w2, pop(p + 'mlp.l2.weight').T)
        put(blk.mlp.w3, pop(p + 'mlp.l3.weight').T)
        if isinstance(blk, AttentionBlock):
            a = blk.attn
            put(a.wqkv, pop(p + 'inner_mha_cls.Wqkv.weight')
                .T.reshape(D, 3, H, Dh))
            put(a.wo, pop(p + 'inner_mha_cls.out_proj.weight')
                .T.reshape(H, Dh, D))
            optional(p + 'inner_mha_cls.Wqkv.bias', cfg.qkv_proj_bias,
                     a.bqkv, (3, H, Dh))
            optional(p + 'inner_mha_cls.out_proj.bias',
                     cfg.mha_out_proj_bias, a.bo, (D,))
            continue
        h = blk.hyena
        poles = pop(p + 'filter.poles')
        residues = pop(p + 'filter.residues')
        put(h.poles, poles.reshape(D, -1, 2))
        put(h.residues, residues.reshape(D, -1, 2))
        fir_w = pop(p + 'filter.short_filter_weight')
        put(h.fir_w, fir_w.reshape(3, D, -1))
        put(h.w_in, pop(p + 'projections.weight').T.reshape(D, 3, D))
        put(h.d_skip, pop(p + 'filter.D'))
        put(h.w_out, pop(p + 'out_filter_dense.weight').T)
        optional(p + 'projections.bias', cfg.hyena_proj_bias, h.b_in, (3, D))
        optional(p + 'filter.short_filter_bias', cfg.short_filter_bias,
                 h.fir_b, (3, D))
        optional(p + 'out_filter_dense.bias', cfg.hyena_out_proj_bias,
                 h.b_out, (D,))
    if sd:
        raise ValueError(f'{len(sd)} unconsumed checkpoint tensors: '
                         f'{sorted(sd)[:10]}')
    return model


def _state_views(model: StripedHyena) -> Dict[str, torch.Tensor]:
    """Reference names -> the model's tensors in torch layouts, as views
    on the model's device (nothing is copied)."""
    cfg = model.config
    D = cfg.hidden_size
    K = cfg.short_filter_length
    for blk in model.blocks:
        for sub in blk.children():
            for name, child in sub.named_children():
                if isinstance(child, QuantizedWeight):
                    raise ValueError(
                        f'the model is quantized ({child.mode} weight '
                        f'{name!r}): stored checkpoints hold unquantized '
                        'weights; save before quantizing, and quantize '
                        'after a load (weight_quant in the config)')
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
    return {k: v.detach() for k, v in sd.items()}


def state_dict(model: StripedHyena) -> Dict[str, torch.Tensor]:
    """Inverse of `params_from_state_dict`: reference names and torch
    layouts, contiguous CPU tensors in the parameters' own types (no
    non-parameter buffers). A quantized model raises."""
    return {k: v.contiguous().to('cpu')
            for k, v in _state_views(model).items()}


def cache_from_jax(cache: Dict[str, Any], cfg: ModelConfig,
                   device: Union[str, torch.device] = 'cuda'
                   ) -> Dict[str, Any]:
    """The JAX package's decode cache, as numpy arrays, as the port's.

    There a cache has one entry per run of layers
    (`ModelConfig.layer_segments`): the KV dict of an attention layer, in
    either layout, or the (fir, iir) states of a Hyena run stacked on a
    leading layer axis. Here it has one entry per layer and a Python int
    offset; a (B,) vector of per-slot offsets (the JAX server's cache)
    becomes an int32 (B,) tensor on `device`. Arrays are copied."""
    layers = []
    for (kind, idxs), seg in zip(cfg.layer_segments(), cache['layers']):
        if kind == 'attn':
            layers.append({k: _as_tensor(np.array(a)).to(device)
                           for k, a in seg.items()})
            continue
        fir, iir = seg
        for j in range(len(idxs)):
            layers.append(HyenaState(
                fir=_as_tensor(np.array(fir[j])).to(device),
                iir=_as_tensor(np.array(iir[j])).to(device)))
    offset = np.asarray(cache['offset'])
    return {'offset': (int(offset) if offset.ndim == 0 else
                       torch.from_numpy(offset.astype(np.int32)).to(device)),
            'layers': layers}


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def cache_to_jax(cache: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Inverse of `cache_from_jax`: numpy arrays in the JAX package's
    layout, a Hyena run as a (fir, iir) pair stacked over its layers, the
    offset an np.int32 scalar or, from a (B,) tensor, an int32 (B,)
    array."""
    layers = []
    for kind, idxs in cfg.layer_segments():
        if kind == 'attn':
            layers.append({k: _as_numpy(t)
                           for k, t in cache['layers'][idxs[0]].items()})
        else:
            run = [cache['layers'][i] for i in idxs]
            layers.append((np.stack([_as_numpy(s.fir) for s in run]),
                           np.stack([_as_numpy(s.iir) for s in run])))
    offset = cache['offset']
    return {'offset': (_as_numpy(offset).astype(np.int32)
                       if isinstance(offset, torch.Tensor)
                       else np.int32(offset)),
            'layers': layers}


def _runs(kinds):
    """(kind, layer indices) of the maximal runs of one kind, in order,
    as `ModelConfig.layer_segments` groups them (attention layers alone)."""
    segs = []
    for i, kind in enumerate(kinds):
        if kind == 'hyena' and segs and segs[-1][0] == 'hyena':
            segs[-1][1].append(i)
        else:
            segs.append((kind, [i]))
    return segs


def lora_to_jax(lora) -> list:
    """The port's adapters (one entry a layer: {'attn' or 'hyena': {name:
    {'a', 'b'}}, 'mlp': {...}}) as the JAX package's adapter tree of
    float32 numpy arrays: one entry a segment, {'attn': ..., 'mlp': ...}
    for an attention layer, {'stack': {'hyena': ..., 'mlp': ...}} for a
    run of Hyena layers, each factor stacked over the run."""
    kinds = ['attn' if 'attn' in e else 'hyena' for e in lora]
    out = []
    for kind, idxs in _runs(kinds):
        if kind == 'attn':
            out.append({sub: {n: {f: _as_numpy(t) for f, t in pr.items()}
                              for n, pr in lora[idxs[0]][sub].items()}
                        for sub in ('attn', 'mlp')})
            continue
        out.append({'stack': {sub: {
            n: {f: np.stack([_as_numpy(lora[i][sub][n][f]) for i in idxs])
                for f in ('a', 'b')}
            for n in lora[idxs[0]][sub]} for sub in ('hyena', 'mlp')}})
    return out


def _lora_unstack(tree, kinds, device) -> list:
    out = []
    for (kind, idxs), seg in zip(_runs(kinds), tree):
        if kind == 'attn':
            out.append({sub: {n: {f: torch.tensor(np.asarray(a, np.float32),
                                                  device=device)
                                  for f, a in pr.items()}
                              for n, pr in seg[sub].items()}
                        for sub in ('attn', 'mlp')})
            continue
        for j in range(len(idxs)):
            out.append({sub: {n: {f: torch.tensor(
                np.asarray(a[j], np.float32), device=device)
                for f, a in pr.items()}
                for n, pr in seg['stack'][sub].items()}
                for sub in ('hyena', 'mlp')})
    return out


def lora_from_jax(tree, cfg: ModelConfig,
                  device: Union[str, torch.device] = 'cuda') -> list:
    """Inverse of `lora_to_jax`: the JAX package's adapter tree (numpy or
    JAX arrays) as the port's, one entry a layer of `cfg`, each run's
    factors unstacked, float32 tensors on `device`."""
    kinds = ['attn' if cfg.is_attn_layer(i) else 'hyena'
             for i in range(cfg.num_layers)]
    if len(tree) != len(_runs(kinds)):
        raise ValueError(f'adapter tree of {len(tree)} segments for a '
                         f'config of {len(_runs(kinds))}')
    return _lora_unstack(tree, kinds, device)


# ---------------------------------------------------------------------------
# safetensors files, read and written here
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
    'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
    'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8,
    'BOOL': torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _read_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor}. The tensors are views
    of a private (copy-on-write) memory map of the file, so pages are
    read when a tensor is used, and the file on disk is never written."""
    with open(path, 'rb') as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f'{path}: not a safetensors file (too short)')
        (n,) = struct.unpack('<Q', head)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f'{path}: header length {n} exceeds the file')
        header = json.loads(f.read(n).decode('utf-8'))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        if info['dtype'] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']}")
        dtype = _ST_DTYPES[info['dtype']]
        shape = tuple(info['shape'])
        begin, end = info['data_offsets']
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * dtype.itemsize or 8 + n + end > size:
            raise ValueError(f'{path}: tensor {name!r} of shape {shape} '
                             f'does not fit its bytes [{begin}, {end})')
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(
                buf, dtype=dtype, count=count,
                offset=8 + n + begin).reshape(shape)
    return out


def _write_safetensors_file(tensors: Dict[str, torch.Tensor],
                            path: str) -> None:
    """Write {name: tensor} as one .safetensors file, one tensor at a time:
    each is brought to the CPU, written and dropped."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f'tensor {name!r}: unsupported dtype {t.dtype}')
        nbytes = t.numel() * t.element_size()
        header[name] = {'dtype': _ST_NAMES[t.dtype],
                        'shape': [int(d) for d in t.shape],
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(',', ':')).encode('utf-8')
    raw += b' ' * (-len(raw) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                # laid out on the tensor's own device, then brought over
                f.write(t.detach().contiguous().to('cpu').reshape(-1)
                        .view(torch.uint8).numpy().data)


def read_safetensors_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A snapshot directory (single `model.safetensors`, the sharded
    `model.safetensors.index.json`, or any `*.safetensors` files) or one
    .safetensors file -> a flat dict of CPU tensors."""
    if os.path.isfile(path):
        files = [path]
    else:
        index = os.path.join(path, 'model.safetensors.index.json')
        single = os.path.join(path, 'model.safetensors')
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)['weight_map']
            files = sorted({os.path.join(path, v)
                            for v in weight_map.values()})
        elif os.path.exists(single):
            files = [single]
        else:
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.endswith('.safetensors'))
            if not files:
                hint = ''
                if os.path.exists(os.path.join(path, _JAX_NATIVE_MARKER)):
                    hint = (' (this is a native checkpoint of the JAX '
                            'package, an orbax directory, which the port '
                            'does not read: export it as a reference '
                            'snapshot)')
                raise FileNotFoundError(
                    f'No model.safetensors[.index.json] under {path}{hint}')
    sd: Dict[str, torch.Tensor] = {}
    for fp in files:
        sd.update(_read_safetensors_file(fp))
    return sd


def strip_backbone_prefix(sd: Dict[str, Array]) -> Dict[str, Array]:
    """Strip the `backbone.` key prefix of a reference snapshot."""
    return {k.removeprefix('backbone.'): v for k, v in sd.items()}


def write_reference_snapshot(model: StripedHyena, path: str,
                             num_shards: int = 1,
                             backbone_prefix: bool = True) -> None:
    """Write the model as a reference-format snapshot: one
    `model.safetensors`, or `model-0000i-of-0000N.safetensors` shards plus
    `model.safetensors.index.json`."""
    sd = _state_views(model)
    if backbone_prefix:
        sd = {'backbone.' + k: v for k, v in sd.items()}
    os.makedirs(path, exist_ok=True)
    if num_shards <= 1:
        _write_safetensors_file(sd, os.path.join(path, 'model.safetensors'))
        return
    keys = sorted(sd)
    per = (len(keys) + num_shards - 1) // num_shards
    weight_map: Dict[str, str] = {}
    for s in range(num_shards):
        chunk = keys[s * per:(s + 1) * per]
        fname = f'model-{s + 1:05d}-of-{num_shards:05d}.safetensors'
        _write_safetensors_file({k: sd[k] for k in chunk},
                                os.path.join(path, fname))
        weight_map.update({k: fname for k in chunk})
    total = sum(v.numel() * v.element_size() for v in sd.values())
    with open(os.path.join(path, 'model.safetensors.index.json'), 'w') as f:
        json.dump({'metadata': {'total_size': total},
                   'weight_map': weight_map}, f, indent=1)


# ---------------------------------------------------------------------------
# Schema validation and config inference against a snapshot
# ---------------------------------------------------------------------------

def expected_state_dict_spec(cfg: ModelConfig) -> Dict[str, tuple]:
    """Engine tensor name -> expected shape for this config."""
    D = cfg.hidden_size
    I = cfg.inner_mlp_size_actual
    V = cfg.padded_vocab_size
    K, S = cfg.short_filter_length, cfg.state_size
    spec: Dict[str, tuple] = {'embedding_layer.weight': (V, D)}
    if not cfg.tie_embeddings:
        spec['unembed.weight'] = (V, D)
    if cfg.final_norm:
        spec['norm.scale'] = (D,)
    for i in range(cfg.num_layers):
        p = f'blocks.{i}.'
        spec[p + 'pre_norm.scale'] = (D,)
        spec[p + 'post_norm.scale'] = (D,)
        spec[p + 'mlp.l1.weight'] = (I, D)
        spec[p + 'mlp.l2.weight'] = (I, D)
        spec[p + 'mlp.l3.weight'] = (D, I)
        if cfg.is_attn_layer(i):
            spec[p + 'inner_mha_cls.Wqkv.weight'] = (3 * D, D)
            spec[p + 'inner_mha_cls.out_proj.weight'] = (D, D)
            if cfg.qkv_proj_bias:
                spec[p + 'inner_mha_cls.Wqkv.bias'] = (3 * D,)
            if cfg.mha_out_proj_bias:
                spec[p + 'inner_mha_cls.out_proj.bias'] = (D,)
        else:
            spec[p + 'projections.weight'] = (3 * D, D)
            spec[p + 'filter.short_filter_weight'] = (3 * D, 1, K)
            spec[p + 'filter.poles'] = (D, S, 1, 2)
            spec[p + 'filter.residues'] = (D, S, 1, 2)
            spec[p + 'filter.D'] = (D,)
            spec[p + 'out_filter_dense.weight'] = (D, D)
            if cfg.hyena_proj_bias:
                spec[p + 'projections.bias'] = (3 * D,)
            if cfg.short_filter_bias:
                spec[p + 'filter.short_filter_bias'] = (3 * D,)
            if cfg.hyena_out_proj_bias:
                spec[p + 'out_filter_dense.bias'] = (D,)
    return spec


def validate_state_dict(sd: Dict[str, Array],
                        cfg: ModelConfig) -> Dict[str, Any]:
    """One-pass diff of a (backbone-stripped) state dict against the
    expected schema: every missing tensor, unexpected tensor and shape
    mismatch at once. `ok` is True iff `params_from_state_dict` will take
    it. Poles / residues may come squeezed as (D, S, 2) and the FIR weight
    as (3D, K)."""
    spec = expected_state_dict_spec(cfg)
    missing = sorted(k for k in spec if k not in sd)
    unexpected = sorted(k for k in sd
                        if k not in spec and not _BUFFER_RE.search(k))
    buffers = sorted(k for k in sd if _BUFFER_RE.search(k))
    mismatched = {
        k: {'expected': tuple(spec[k]), 'got': tuple(sd[k].shape)}
        for k in spec
        if k in sd and tuple(sd[k].shape) != tuple(spec[k])
        and not (k.endswith(('.poles', '.residues'))
                 and tuple(sd[k].shape) == tuple(spec[k][:2]) + (2,))
        and not (k.endswith('.short_filter_weight')
                 and tuple(sd[k].shape) == (spec[k][0], spec[k][2]))}
    return {
        'ok': not (missing or unexpected or mismatched),
        'n_tensors': len(sd), 'n_expected': len(spec),
        'missing': missing, 'unexpected': unexpected,
        'shape_mismatch': mismatched, 'ignored_buffers': buffers,
        'reconstructed_layouts': dict(RECONSTRUCTED_LAYOUTS),
    }


def format_validation_report(report: Dict[str, Any]) -> str:
    lines = [f"schema check: {'OK' if report['ok'] else 'FAILED'} "
             f"({report['n_tensors']} tensors in snapshot, "
             f"{report['n_expected']} expected)"]
    for key in ('missing', 'unexpected'):
        for k in report[key]:
            lines.append(f'  {key}: {k}')
    for k, d in report['shape_mismatch'].items():
        lines.append(f"  shape mismatch: {k} expected {d['expected']} "
                     f"got {d['got']}")
    if report['ignored_buffers']:
        lines.append(f"  ignored {len(report['ignored_buffers'])} "
                     f"non-parameter buffers")
    rec = report.get('reconstructed_layouts', {})
    if rec:
        lines.append(
            f'  NOTE: {len(rec)} layout assumptions are RECONSTRUCTED (no '
            'engine source available to cite) and are NOT proven by this '
            'shape check; a numerical parity run on a real snapshot is:')
        for name, what in rec.items():
            lines.append(f'    reconstructed: {name}: {what}')
    return '\n'.join(lines)


def fingerprint_params(model: StripedHyena) -> Dict[str, Dict[str, Any]]:
    """A cheap numeric fingerprint per tensor that a wrong layout cannot
    survive. `l2` and `mean` do not depend on the order of the values
    (they agree when the same values were loaded, in whatever layout);
    `proj`, the dot with cos(0.81 i) over the raveled tensor, changes
    under any row, block or interleave permutation or a real/imaginary
    swap. Summed in float64, 16M elements at a time."""
    out: Dict[str, Dict[str, Any]] = {}
    chunk = 1 << 24
    named = list(model.named_parameters()) + list(model.named_buffers())
    for name, leaf in named:
        flat = leaf.detach().reshape(-1)
        sq = s = proj = 0.0
        for start in range(0, flat.numel(), chunk):
            c = flat[start:start + chunk].double()
            idx = torch.arange(start, start + c.numel(), dtype=torch.float64,
                               device=c.device)
            sq += float(c @ c)
            s += float(c.sum())
            proj += float(c @ torch.cos(0.81 * idx))
        out[name] = {
            'shape': [int(d) for d in leaf.shape],
            'dtype': str(leaf.dtype).removeprefix('torch.'),
            'l2': sq ** 0.5,
            'mean': s / max(flat.numel(), 1),
            'proj': proj,
        }
    return out


def compare_fingerprints(got: Dict[str, Dict[str, Any]],
                         want: Dict[str, Dict[str, Any]],
                         rtol: float = 1e-3) -> List[str]:
    """Differences between two `fingerprint_params` results; [] when they
    match. Tolerances scale with each tensor's l2. A matching l2 with a
    differing proj is tagged as the signature of a layout error."""
    problems = []
    for k in sorted(set(got) | set(want)):
        if k not in got:
            problems.append(f'{k}: missing from converted tree')
            continue
        if k not in want:
            problems.append(f'{k}: unexpected leaf')
            continue
        g, w = got[k], want[k]
        if list(g['shape']) != list(w['shape']):
            problems.append(f"{k}: shape {g['shape']} != {w['shape']}")
            continue
        scale = max(abs(w['l2']), 1e-12)
        l2_ok = abs(g['l2'] - w['l2']) <= rtol * scale
        for stat in ('l2', 'mean', 'proj'):
            if abs(g[stat] - w[stat]) > rtol * scale:
                tag = (' [same norms, different order -> LAYOUT error]'
                       if stat == 'proj' and l2_ok else '')
                problems.append(
                    f"{k}: {stat} {g[stat]:.8g} != {w[stat]:.8g}{tag}")
    return problems


def infer_config_overrides(sd: Dict[str, Array],
                           cfg: ModelConfig) -> Dict[str, Any]:
    """Architecture fields read off a (backbone-stripped) snapshot's
    tensor shapes, the checkpoint being ground truth: depth, the layer
    partition (attention layers are those with `inner_mha_cls` tensors),
    `inner_mlp_size`, `state_size`, `short_filter_length`. Returns only
    the fields that differ from `cfg`."""
    ovr: Dict[str, Any] = {}
    layer_ids = sorted({int(m.group(1)) for k in sd
                        if (m := re.match(r'blocks\.(\d+)\.', k))})
    if layer_ids:
        n_layers = layer_ids[-1] + 1
        attn = tuple(i for i in layer_ids
                     if f'blocks.{i}.inner_mha_cls.Wqkv.weight' in sd)
        if (n_layers != cfg.num_layers
                or attn != tuple(cfg.attn_layer_idxs)):
            # the FULL partition whenever depth or placement differs:
            # `replace` would keep the stale hyena_layer_idxs otherwise
            if n_layers != cfg.num_layers:
                ovr['num_layers'] = n_layers
            ovr['attn_layer_idxs'] = attn
            ovr['hyena_layer_idxs'] = tuple(
                i for i in range(n_layers) if i not in attn)
    emb = sd.get('embedding_layer.weight')
    if emb is not None and emb.shape[1] != cfg.hidden_size:
        raise ValueError(
            f'snapshot hidden_size {emb.shape[1]} != config '
            f'{cfg.hidden_size}: wrong config for this checkpoint')
    for i in layer_ids:
        l1 = sd.get(f'blocks.{i}.mlp.l1.weight')
        if l1 is not None:
            if l1.shape[0] != cfg.inner_mlp_size_actual:
                ovr['inner_mlp_size'] = int(l1.shape[0])
            break
    for i in layer_ids:
        poles = sd.get(f'blocks.{i}.filter.poles')
        if poles is not None:
            if poles.shape[1] != cfg.state_size:
                ovr['state_size'] = int(poles.shape[1])
            fir = sd.get(f'blocks.{i}.filter.short_filter_weight')
            if fir is not None and fir.shape[-1] != cfg.short_filter_length:
                ovr['short_filter_length'] = int(fir.shape[-1])
            break
    return ovr


def load_reference_checkpoint(path: str, cfg: ModelConfig,
                              device: Union[str, torch.device] = 'cuda',
                              mesh=None) -> StripedHyena:
    """A reference snapshot -> the port's model on `device` (this rank's
    shards under a mesh)."""
    sd = strip_backbone_prefix(read_safetensors_state_dict(path))
    return params_from_state_dict(sd, cfg, device, mesh)


def load_reference_checkpoint_adaptive(
        path: str, cfg: ModelConfig,
        device: Union[str, torch.device] = 'cuda', verbose: bool = True,
        mesh=None) -> Tuple[StripedHyena, ModelConfig]:
    """Load a reference snapshot with the checkpoint as ground truth:
    infer the architecture fields from its shapes, validate the whole
    schema in one pass, then build the model. Returns (model, adapted
    config); callers must use the returned config."""
    sd = strip_backbone_prefix(read_safetensors_state_dict(path))
    ovr = infer_config_overrides(sd, cfg)
    if ovr:
        if verbose:
            print(f'[evo_tpu_torch.checkpoint] adapting config to snapshot '
                  f'shapes: {ovr}', flush=True)
        cfg = cfg.replace(**ovr)
    report = validate_state_dict(sd, cfg)
    if not report['ok']:
        raise ValueError('reference snapshot does not match the engine '
                         'schema:\n' + format_validation_report(report))
    return params_from_state_dict(sd, cfg, device, mesh), cfg


# ---------------------------------------------------------------------------
# Native format
# ---------------------------------------------------------------------------

def save_native(model: StripedHyena, path: str,
                cfg: Optional[ModelConfig] = None,
                num_shards: int = 1) -> None:
    """Write the model as a native checkpoint: its tensors in the
    reference names (no prefix) as safetensors, plus the marker with the
    config."""
    path = os.path.abspath(path)
    write_reference_snapshot(model, path, num_shards=num_shards,
                             backbone_prefix=False)
    meta: Dict[str, Any] = {'format': 'evo_tpu_torch', 'version': 1}
    if cfg is not None:
        meta['config'] = {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items()}
    with open(os.path.join(path, NATIVE_MARKER), 'w') as f:
        json.dump(meta, f, indent=1)


def load_native(path: str, cfg: ModelConfig,
                device: Union[str, torch.device] = 'cuda',
                mesh=None) -> StripedHyena:
    return load_reference_checkpoint(os.path.abspath(path), cfg, device,
                                     mesh)


def native_config(path: str) -> Optional[ModelConfig]:
    marker = os.path.join(os.path.abspath(path), NATIVE_MARKER)
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        meta = json.load(f)
    if 'config' not in meta:
        return None
    return ModelConfig.from_dict(meta['config'])


# fields that fix the shapes and structure of the parameters: the config
# saved with a native checkpoint is ground truth for these; every other
# field (types, quantization, serving switches) stays the caller's
_ARCH_FIELDS = (
    'vocab_size', 'hidden_size', 'num_filters', 'num_layers',
    'attn_layer_idxs', 'hyena_layer_idxs', 'short_filter_length',
    'num_attention_heads', 'state_size', 'inner_mlp_size',
    'inner_size_multiple_of', 'make_vocab_size_divisible_by',
    'proj_groups', 'hyena_filter_groups', 'tie_embeddings',
    'qkv_proj_bias', 'mha_out_proj_bias', 'hyena_proj_bias',
    'hyena_out_proj_bias', 'short_filter_bias', 'final_norm',
)


def reconcile_native_config(path: str, cfg: ModelConfig) -> ModelConfig:
    """`cfg` with the architecture fields of the config saved beside a
    native checkpoint, so that a checkpoint saved under an adapted config
    (a true inner_mlp_size, a shifted attention placement) reloads under
    it and not under the registry default."""
    saved = native_config(path)
    if saved is None:
        return cfg
    ovr = {f: getattr(saved, f) for f in _ARCH_FIELDS
           if getattr(saved, f) != getattr(cfg, f)}
    return cfg.replace(**ovr) if ovr else cfg


def is_native_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(os.path.abspath(path), NATIVE_MARKER))


def load_params_auto(path: str, cfg: ModelConfig,
                     device: Union[str, torch.device] = 'cuda',
                     mesh=None) -> StripedHyena:
    """Load a native checkpoint or a reference snapshot, whichever `path`
    holds, under `cfg` as it is."""
    if is_native_checkpoint(path):
        return load_native(path, cfg, device, mesh)
    return load_reference_checkpoint(path, cfg, device, mesh)


# ---------------------------------------------------------------------------
# A JAX quantized tree -> the port's quantized layers
# ---------------------------------------------------------------------------

def quantized_layers_from_jax(model: StripedHyena,
                              params: Dict[str, Any]) -> StripedHyena:
    """Set the port's quantized layers from a quantized parameter tree of
    the JAX package (`evo_tpu.quant.quantize_params`), given as numpy
    arrays: every {'q', 's'} or {'q4', 's4'} leaf takes the place of the
    matching weight of `model`, in place; a run of Hyena layers stacked on
    a leading axis is split per layer. Unquantized leaves are not read:
    `model` already holds them (`params_from_state_dict`)."""
    blocks = []
    for (kind, idxs), seg in zip(model.config.layer_segments(),
                                 params['segments']):
        if kind == 'attn':
            blocks.append((idxs[0], seg, None))
        else:
            blocks.extend((li, seg['stack'], j) for j, li in enumerate(idxs))
    for li, tree, j in blocks:
        blk = model.blocks[li]
        for sub in ('mlp', 'attn', 'hyena'):
            for name, leaf in tree.get(sub, {}).items():
                if not (isinstance(leaf, dict)
                        and ('q' in leaf or 'q4' in leaf)):
                    continue
                mode, (cn, sn) = (('int8', ('q', 's')) if 'q' in leaf
                                  else ('int4', ('q4', 's4')))
                codes, scales = (
                    _as_tensor(np.array(leaf[n] if j is None
                                        else leaf[n][j]))
                    .to(model.device) for n in (cn, sn))
                owner = getattr(blk, sub)
                shape = tuple(getattr(owner, name).shape)
                delattr(owner, name)
                setattr(owner, name, QuantizedWeight(
                    mode, codes, scales, logical_shape=shape))
    return model
