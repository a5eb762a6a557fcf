"""Model registry and engine facade (port of `evo_tpu/models.py`).

    model(input_ids)                          -> (logits, None)
    model(x, inference_params_dict=cache)     -> (logits, cache)
    model(x, inference_params_dict=cache, donate_cache=True, resume=True)
    model.initialize_inference_params(b, t)   -> cache

`Evo` keeps the reference's positional `device` argument and honours it:
weights live on that device, "cuda" by default.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from evo_tpu_torch import model as model_lib
from evo_tpu_torch.config import EVO_1_8K_BASE, EVO_1_131K_BASE, ModelConfig
from evo_tpu_torch.tokenizer import CharLevelTokenizer

MODEL_NAMES = [
    'evo-1.5-8k-base',
    'evo-1-8k-base',
    'evo-1-131k-base',
    'evo-1-8k-crispr',
    'evo-1-8k-transposon',
]


def config_for_model(model_name: str) -> ModelConfig:
    """The 8k config for every 8k variant, the 131k config for 131k."""
    if model_name not in MODEL_NAMES:
        raise ValueError(
            f'Invalid model name {model_name}. Options: {MODEL_NAMES}')
    return ModelConfig.from_dict(
        EVO_1_131K_BASE if '131k' in model_name else EVO_1_8K_BASE)


class EvoModel:
    """Engine facade over a `model.StripedHyena` and its config."""

    def __init__(self, config: ModelConfig, module: model_lib.StripedHyena):
        self.config = config
        self.module = module

    @property
    def device(self) -> torch.device:
        return self.module.device

    def __call__(self, input_ids, inference_params_dict=None,
                 donate_cache: bool = False, resume=None):
        """No cache: forward, returns (logits, None). With a cache: a
        decode step for a length-1 input, else a prefill; returns (logits,
        cache).

        resume: continue from a filled cache. None derives it from the
        cache's offset (a Python int here, so nothing waits on the device);
        segmented loops pass it as they do in the JAX package.

        donate_cache: the port updates the passed cache in place whether or
        not it is donated, and returns that same dict, so a caller that
        wants the old state clones it first. The keyword keeps the
        reference's routing: a donated length-1 input takes the prefill,
        not the decode step."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if ids.dim() == 1:
            ids = ids[None]
        if inference_params_dict is None:
            return model_lib.forward(self.module, ids), None
        if ids.shape[1] == 1 and not donate_cache:
            logits, cache = model_lib.decode_step(self.module, ids[:, 0],
                                                  inference_params_dict)
            return logits[:, None], cache
        if resume is None:
            resume = inference_params_dict['offset'] > 0
        return model_lib.prefill(self.module, ids, inference_params_dict,
                                 resume=bool(resume))

    def initialize_inference_params(self, batch_size: int, max_len: int):
        return model_lib.init_cache(self.config, batch_size, max_len,
                                    self.device)

    @property
    def num_params(self) -> int:
        return model_lib.param_count(self.module)


class Evo:
    """Top-level convenience class: validates the model name and yields
    `.model` (an `EvoModel`) and `.tokenizer`."""

    def __init__(self, model_name: str = 'evo-1-8k-base',
                 device: Union[str, torch.device] = 'cuda',
                 checkpoint_path: Optional[str] = None,
                 random_init: bool = False,
                 seed: int = 0,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                'meshes (tensor, data and context parallelism) are not '
                'ported yet (ROADMAP.md, modules queue: parallelism)')
        self.device = model_lib.resolve_device(device)
        config = config_for_model(model_name)
        if config_overrides:
            config = config.replace(**config_overrides)
        if not random_init:
            raise NotImplementedError(
                f'loading checkpoint weights ({checkpoint_path or model_name}'
                ') is not ported yet (ROADMAP.md, modules queue: checkpoint '
                'and safetensors); use random_init=True, or build the model '
                'from a state dict with evo_tpu_torch.checkpoint.'
                'params_from_state_dict')
        gen = torch.Generator(device=self.device).manual_seed(seed)
        module = model_lib.random_init(config, gen, self.device)
        self.config = config
        self.model = EvoModel(config, module)
        self.tokenizer = CharLevelTokenizer(512)
