"""Model configuration schema (PyTorch port).

The port's own copy of `evo_tpu/config.py`: it cannot import that module,
because importing anything under `evo_tpu` runs `evo_tpu/__init__.py`,
which imports JAX. Field names match the reference YAML keys. The fields
of the JAX package that the port has no use for (`use_pallas`, the
FFT-backend knobs, and `mlp_init_method` / `mlp_output_init_method`,
which no code of the JAX package reads) are dropped: `from_dict` ignores
unknown keys, so the published YAMLs still load. `cp_attn` picks the
context-parallel attention (`parallel/`), as there. `hyena_fused_mixer` and
`hyena_pallas_prefix` keep their JAX names: they select kernels that the
port has too. `remat` recomputes blocks on the backward pass, as there.

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
    # activations / matmuls, and the stored weights; poles and residues
    # are always float32 (reference `to_bfloat16_except_poles_residues`).
    # The two may differ (float32 weights under bf16 activations): the
    # sites cast each weight into the activation type where the JAX
    # package does, and kernels 1, 2 and 6 read float32 weights as stored
    compute_dtype: str = 'bfloat16'
    param_dtype: str = 'bfloat16'
    # recompute each block on the backward pass (training; model.py wraps
    # every block of the cache-free forward in torch.utils.checkpoint)
    remat: bool = False
    # chunk (= Toeplitz tile) of the long conv, ops/fftconv.py
    hyena_matmul_chunk: int = 64
    # opt-in: the whole mixer core between the two projections (FIR, gates,
    # chunked conv, modal carry) as one kernel, ops/hyena_mixer.py, where
    # its shape rule holds; the fields alone decide (there is no
    # `use_pallas`): a CUDA tensor takes the kernel, a CPU tensor its plain
    # version
    hyena_fused_mixer: bool = False
    # opt-in: the cross-chunk prefix of the unfused long conv as one
    # kernel, ops/modal_prefix.py
    hyena_pallas_prefix: bool = False
    # opt-in quantized modes (quant.py): weight_quant 'none' | 'int8' |
    # 'int4', act_quant 'none' | 'int8' (needs int8 weights), and the int8
    # KV cache, kv_quant 'none' | 'int8'
    weight_quant: str = 'none'
    act_quant: str = 'none'
    kv_quant: str = 'none'
    # the attention of a context-parallel mesh (cp > 1): 'ulysses' (an
    # all-to-all to H/(tp*cp) heads over the whole sequence, the causal
    # flash kernel on them), 'ring' (K/V blocks passed around the cp
    # group, a float32 online softmax) or 'zigzag' (the ring over balanced
    # chunk pairs)
    cp_attn: str = 'ulysses'

    def __post_init__(self):
        assert self.cp_attn in ('ulysses', 'ring', 'zigzag'), self.cp_attn
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
        if self.weight_quant not in ('none', 'int8', 'int4'):
            raise ValueError(f'unknown weight_quant {self.weight_quant!r} '
                             f"(expected 'none', 'int8' or 'int4')")
        if self.act_quant not in ('none', 'int8'):
            raise ValueError(f'unknown act_quant {self.act_quant!r}')
        if self.kv_quant not in ('none', 'int8'):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got "
                             f'{self.kv_quant!r}')

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


def cli_quant_overrides(quant: str) -> dict:
    """The config overrides of the CLIs' `--quant` choice: 'int8' is
    weight-only, 'int8x8' int8 weights with dynamic int8 activations,
    'int4' the memory-fit mode, 'none' nothing (bf16)."""
    if quant == 'none':
        return {}
    if quant not in ('int8', 'int8x8', 'int4'):
        raise ValueError(f'unknown --quant {quant!r}')
    ov = {'weight_quant': 'int8' if quant == 'int8x8' else quant}
    if quant == 'int8x8':
        ov['act_quant'] = 'int8'
    return ov


def tiny_config(**overrides) -> ModelConfig:
    """A small CPU-runnable config with the schema of evo-1-8k-base (the
    same values as `evo_tpu.config.tiny_config`, minus the fields the port
    drops)."""
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
