"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, never falls back from CUDA to the CPU, and its copies of the JAX
package's configuration agree with the originals."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch
import yaml

from evo_tpu.config import ModelConfig as JaxModelConfig
from evo_tpu.config import cli_tiny_overrides as jax_cli_tiny_overrides
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu.models import config_for_model as jax_config_for_model
from evo_tpu_torch import config
from evo_tpu_torch import model as model_lib
from evo_tpu_torch.models import MODEL_NAMES, Evo, config_for_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'evo_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'evo_tpu')
# fields of the JAX config that the port drops: the kernel on/off switch
# (in the port a tensor's device decides) and the two init-method strings
# that no code of the JAX package reads. The kernel selectors
# `hyena_fused_mixer` and `hyena_pallas_prefix`, the long conv's backend
# and its knobs (`hyena_conv_backend`, `hyena_fft_chunk`,
# `state_prefill_chunk`) and `remat` are fields of both.
TPU_FIELDS = {'use_pallas', 'mlp_init_method', 'mlp_output_init_method'}


def _port_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def _imported(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for mod in _imported(path):
        top = mod.split('.')[0]
        assert top not in FORBIDDEN, f'{path} imports {mod}'


def test_import_leaves_jax_unloaded():
    code = ('import sys, evo_tpu_torch, evo_tpu_torch.checkpoint, '
            'evo_tpu_torch.quant, evo_tpu_torch.cli.score, '
            'evo_tpu_torch.cli.generate, evo_tpu_torch.io.fasta, '
            'evo_tpu_torch.ops.hyena_mixer, evo_tpu_torch.ops.modal_prefix, '
            'evo_tpu_torch.ops.mlp_gate, evo_tpu_torch.speculative, '
            'evo_tpu_torch.runtime, evo_tpu_torch.io.fastio, '
            'evo_tpu_torch.io.prefetch, evo_tpu_torch.training, '
            'evo_tpu_torch.lora, evo_tpu_torch.io.dataset, '
            'evo_tpu_torch.cli.finetune, evo_tpu_torch.utils, '
            'evo_tpu_torch.cli.example_inference, '
            'evo_tpu_torch.cli.generation_to_folding, '
            'evo_tpu_torch.cli.verify_parity, '
            'evo_tpu_torch.examples.hello_evo, '
            'evo_tpu_torch.examples.long_context; '
            'assert "jax" not in sys.modules and "evo_tpu" not in '
            'sys.modules, sorted(sys.modules)')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Evo('evo-1-8k-base', random_init=True)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Evo('evo-1-8k-base', 'cuda', random_init=True,
            config_overrides=config.cli_tiny_overrides())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model_lib.random_init(config.tiny_config(), torch.Generator())


@pytest.mark.parametrize('name', sorted(config.PUBLISHED_CONFIGS))
def test_published_constants_equal_yaml(name):
    with open(os.path.join(ROOT, 'evo_tpu', 'configs', name)) as f:
        raw = yaml.safe_load(f)
    assert config.PUBLISHED_CONFIGS[name] == raw


@pytest.mark.parametrize('name', MODEL_NAMES)
def test_configs_agree_with_jax(name):
    port = dataclasses.asdict(config_for_model(name))
    ref = dataclasses.asdict(jax_config_for_model(name))
    assert port == {k: v for k, v in ref.items() if k not in TPU_FIELDS}
    assert config_for_model(name).inner_mlp_size_actual == 10928


def test_tiny_configs_agree_with_jax():
    port = dataclasses.asdict(config.tiny_config())
    ref = dataclasses.asdict(jax_tiny_config())
    assert port == {k: v for k, v in ref.items() if k not in TPU_FIELDS}
    assert config.tiny_config().layer_segments() == \
        jax_tiny_config().layer_segments()
    assert config.cli_tiny_overrides() == {
        k: v for k, v in jax_cli_tiny_overrides().items()
        if k not in TPU_FIELDS}
    assert {f.name for f in dataclasses.fields(JaxModelConfig)} - {
        f.name for f in dataclasses.fields(config.ModelConfig)} == TPU_FIELDS


@pytest.mark.parametrize('field', ['hyena_fused_mixer', 'hyena_pallas_prefix'])
def test_kernel_selectors_are_fields_of_both_packages(field):
    """The two selectors keep the JAX names, types and defaults (off), so
    `from_dict`, the YAMLs and `config_overrides` treat them alike."""
    port = {f.name: f for f in dataclasses.fields(config.ModelConfig)}
    ref = {f.name: f for f in dataclasses.fields(JaxModelConfig)}
    assert field not in TPU_FIELDS
    assert port[field].default is ref[field].default is False
    assert port[field].type == ref[field].type
    assert getattr(config.ModelConfig.from_dict({field: True}), field)
    assert getattr(config.tiny_config().replace(**{field: True}), field)


@pytest.mark.parametrize('field,value', [('hyena_conv_backend', 'fft'),
                                         ('hyena_fft_chunk', 8192),
                                         ('state_prefill_chunk', 32)])
def test_fft_backend_fields_are_fields_of_both_packages(field, value):
    """The FFT backend's fields keep the JAX names, types and defaults, so
    `from_dict`, the YAMLs and `config_overrides` treat them alike; the
    tiny configs set state_prefill_chunk alike, and an unknown backend
    raises."""
    port = {f.name: f for f in dataclasses.fields(config.ModelConfig)}
    ref = {f.name: f for f in dataclasses.fields(JaxModelConfig)}
    assert field not in TPU_FIELDS
    assert port[field].default == ref[field].default
    assert port[field].type == ref[field].type
    assert getattr(config.ModelConfig.from_dict({field: value}), field) == \
        value
    assert getattr(config.tiny_config(), field) == \
        getattr(jax_tiny_config(), field)
    with pytest.raises(ValueError, match='hyena_conv_backend'):
        config.tiny_config(hyena_conv_backend='toeplitz')


def test_from_yaml_reads_published_file():
    path = os.path.join(ROOT, 'evo_tpu', 'configs',
                        'evo-1-131k-base_inference.yml')
    cfg = config.ModelConfig.from_yaml(path)
    assert cfg == config_for_model('evo-1-131k-base')
    assert cfg.use_interpolated_rotary_pos_emb
    assert cfg.rotary_emb_scaling_factor == 16
    assert cfg.hyena_fft_chunk == 8192
