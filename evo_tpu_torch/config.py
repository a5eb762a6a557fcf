"""Model configuration schema (PyTorch port).

The port's own copy of `evo_tpu/config.py`: it cannot import that module,
because importing anything under `evo_tpu` runs `evo_tpu/__init__.py`,
which imports JAX. Field names match the reference YAML keys. The TPU-only
fields of the JAX package (`use_pallas`, `hyena_fused_mixer`,
`hyena_pallas_prefix`, `cp_attn`, and the FFT-backend knobs) are dropped:
`from_dict` ignores unknown keys, so the published YAMLs still load.

The two published inference configs are held as dict constants below,
transcribed from `evo_tpu/configs/*.yml`, because PyYAML is not a
dependency of the port (`from_yaml` imports it lazily).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

_HYENA_IDXS_7B = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 17,
                  18, 19, 20, 21, 22, 23, 25, 26, 27, 28, 29, 30, 31)

# evo_tpu/configs/evo-1-8k-base_inference.yml, key for key
EVO_1_8K_BASE = {
    'vocab_size': 512,
    'hidden_size': 4096,
    'num_filters': 4096,
    'max_sequence_len': 8192,
    'attn_layer_idxs': [8, 16, 24],
    'hyena_layer_idxs': list(_HYENA_IDXS_7B),
    'num_layers': 32,
    'short_filter_length': 3,
    'num_attention_heads': 32,
    'short_filter_bias': True,
    'eps': 1.0e-6,
    'state_size': 8,
    'inner_size_multiple_of': 16,
    'smeared_gqa': False,
    'make_vocab_size_divisible_by': 8,
    'log_intermediate_values': False,
    'proj_groups': 1,
    'hyena_filter_groups': 1,
    'split_k0': True,
    'model_parallel_size': 1,
    'pile_parallel_size': 1,
    'tie_embeddings': True,
    'inner_mlp_size': None,
    'mha_out_proj_bias': True,
    'qkv_proj_bias': True,
    'final_norm': True,
    'rng_fork': False,
    'use_flash_attn': True,
    'use_flash_rmsnorm': False,
    'use_flash_depthwise': False,
    'use_flashfft': False,
    'column_split': True,
    'inference_mode': True,
    'tokenizer_type': 'CharLevelTokenizer',
    'prefill_style': 'fft',
    'mlp_activation': 'gelu',
}

# evo_tpu/configs/evo-1-131k-base_inference.yml: the 8k config plus rotary
# position interpolation (and a chunk knob of the JAX FFT backend, which
# the port's matmul-only long conv does not read)
EVO_1_131K_BASE = dict(
    EVO_1_8K_BASE,
    use_interpolated_rotary_pos_emb=True,
    rotary_emb_scaling_factor=16,
    hyena_fft_chunk=8192,
)

PUBLISHED_CONFIGS = {
    'evo-1-8k-base_inference.yml': EVO_1_8K_BASE,
    'evo-1-131k-base_inference.yml': EVO_1_131K_BASE,
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """StripedHyena architecture hyperparameters (reference YAML keys)."""

    vocab_size: int = 512
    hidden_size: int = 4096
    num_filters: int = 4096
    max_sequence_len: int = 8192
    attn_layer_idxs: Tuple[int, ...] = (8, 16, 24)
    hyena_layer_idxs: Tuple[int, ...] = ()
    num_layers: int = 32
    short_filter_length: int = 3
    num_attention_heads: int = 32
    short_filter_bias: bool = True
    eps: float = 1.0e-6
    state_size: int = 8
    inner_size_multiple_of: int = 16
    smeared_gqa: bool = False
    make_vocab_size_divisible_by: int = 8
    log_intermediate_values: bool = False
    proj_groups: int = 1
    hyena_filter_groups: int = 1
    split_k0: bool = True
    model_parallel_size: int = 1
    pile_parallel_size: int = 1
    tie_embeddings: bool = True
    inner_mlp_size: Optional[int] = None
    mha_out_proj_bias: bool = True
    qkv_proj_bias: bool = True
    hyena_proj_bias: bool = True
    hyena_out_proj_bias: bool = True
    final_norm: bool = True
    rng_fork: bool = False
    use_flash_attn: bool = True
    use_flash_rmsnorm: bool = False
    use_flash_depthwise: bool = False
    use_flashfft: bool = False
    column_split: bool = True
    inference_mode: bool = True
    tokenizer_type: str = 'CharLevelTokenizer'
    prefill_style: str = 'fft'
    mlp_activation: str = 'gelu'
    use_interpolated_rotary_pos_emb: bool = False
    rotary_emb_scaling_factor: float = 1.0
    rotary_base: float = 10000.0
    # activations / matmuls; poles and residues are always float32
    # (reference `to_bfloat16_except_poles_residues`)
    compute_dtype: str = 'bfloat16'
    param_dtype: str = 'bfloat16'
    # chunk (= Toeplitz tile) of the long conv, ops/fftconv.py
    hyena_matmul_chunk: int = 64
    # quantized modes: only 'none' is ported (see ROADMAP.md)
    weight_quant: str = 'none'
    act_quant: str = 'none'
    kv_quant: str = 'none'

    def __post_init__(self):
        object.__setattr__(self, 'attn_layer_idxs',
                           tuple(self.attn_layer_idxs))
        if not self.hyena_layer_idxs:
            object.__setattr__(
                self, 'hyena_layer_idxs',
                tuple(i for i in range(self.num_layers)
                      if i not in self.attn_layer_idxs))
        else:
            object.__setattr__(self, 'hyena_layer_idxs',
                               tuple(self.hyena_layer_idxs))
        if sorted(self.attn_layer_idxs + self.hyena_layer_idxs) != \
                list(range(self.num_layers)):
            raise ValueError('layer idxs must partition layers')
        if self.hidden_size % self.num_attention_heads:
            raise ValueError('hidden_size must divide into heads')
        if self.proj_groups != 1 or self.smeared_gqa:
            raise NotImplementedError(
                'grouped-query attention (proj_groups != 1 / smeared_gqa) '
                'is not implemented; all reference checkpoints use MHA')
        if self.hyena_filter_groups not in (0, 1):
            raise NotImplementedError(
                'hyena_filter_groups > 1 is not implemented; reference '
                'configs use 1')
        for name in ('weight_quant', 'act_quant', 'kv_quant'):
            if getattr(self, name) != 'none':
                raise NotImplementedError(
                    f'{name}={getattr(self, name)!r} is not ported yet '
                    f'(ROADMAP.md, modules queue: quantized modes)')
        if self.param_dtype != self.compute_dtype:
            raise NotImplementedError(
                'param_dtype != compute_dtype is not ported: the port keeps '
                'its weights in the activation type (ROADMAP.md, modules '
                'queue: quantized modes)')

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, self.make_vocab_size_divisible_by)

    @property
    def inner_mlp_size_actual(self) -> int:
        """GLU inner width: 2/3 of 4x hidden rounded up to
        `inner_size_multiple_of` when the YAML leaves it null (4096 ->
        10928)."""
        if self.inner_mlp_size is not None:
            return self.inner_mlp_size
        return _round_up(int(2 * self.hidden_size * 4 / 3),
                         self.inner_size_multiple_of)

    def is_attn_layer(self, idx: int) -> bool:
        return idx in self.attn_layer_idxs

    def layer_segments(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        """Layers grouped into maximal runs of one kind, in order, as in
        the JAX package (the port runs every layer on its own, but keeps
        the grouping for tooling that reports by run)."""
        segs = []
        run = []
        for li in range(self.num_layers):
            if self.is_attn_layer(li):
                if run:
                    segs.append(('hyena', tuple(run)))
                    run = []
                segs.append(('attn', (li,)))
            else:
                run.append(li)
        if run:
            segs.append(('hyena', tuple(run)))
        return tuple(segs)

    @classmethod
    def from_yaml(cls, path: str) -> 'ModelConfig':
        import yaml
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    @classmethod
    def from_dict(cls, raw: dict) -> 'ModelConfig':
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def replace(self, **kw) -> 'ModelConfig':
        return dataclasses.replace(self, **kw)


def cli_tiny_overrides() -> dict:
    """The `--tiny` override dict of the CLIs (same schema family as
    `tiny_config`)."""
    return dict(
        hidden_size=64, num_filters=64, num_layers=4,
        attn_layer_idxs=(1,), hyena_layer_idxs=(),
        num_attention_heads=4, state_size=4, compute_dtype='float32',
        param_dtype='float32')


def tiny_config(**overrides) -> ModelConfig:
    """A small CPU-runnable config with the schema of evo-1-8k-base (the
    same values as `evo_tpu.config.tiny_config`, minus its TPU fields)."""
    base = dict(
        vocab_size=512,
        hidden_size=64,
        num_filters=64,
        max_sequence_len=256,
        attn_layer_idxs=(1,),
        hyena_layer_idxs=(),
        num_layers=4,
        short_filter_length=3,
        num_attention_heads=4,
        state_size=4,
        inner_size_multiple_of=16,
        compute_dtype='float32',
        param_dtype='float32',
    )
    base.update(overrides)
    return ModelConfig(**base)
