"""Model registry and engine facade (port of `evo_tpu/models.py`).

    model(input_ids)                          -> (logits, None)
    model(x, inference_params_dict=cache)     -> (logits, cache)
    model(x, inference_params_dict=cache, donate_cache=True, resume=True)
    model.initialize_inference_params(b, t)   -> cache

`Evo` keeps the reference's positional `device` argument and honours it:
weights live on that device, "cuda" by default.

With a mesh (`parallel.make_mesh`, one process per card) every rank
builds the same `Evo` and holds its tensor-parallel shards. The facade
splits each batch over dp: a dp rank runs its rows (`collectives.
shard_rows`) against a cache of its rows, and the logits are gathered
over dp, so every rank returns the whole result, as the JAX package's
dp-sharded program does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from evo_tpu_torch import model as model_lib
from evo_tpu_torch.config import EVO_1_8K_BASE, EVO_1_131K_BASE, ModelConfig
from evo_tpu_torch.parallel.collectives import gather_rows, shard_rows
from evo_tpu_torch.tokenizer import CharLevelTokenizer

MODEL_NAMES = [
    'evo-1.5-8k-base',
    'evo-1-8k-base',
    'evo-1-131k-base',
    'evo-1-8k-crispr',
    'evo-1-8k-transposon',
]

# the HF repositories of the published snapshots
HF_MODEL_NAME_MAP = {name: 'evo-design/' + name for name in MODEL_NAMES}


def config_for_model(model_name: str) -> ModelConfig:
    """The 8k config for every 8k variant, the 131k config for 131k."""
    if model_name not in MODEL_NAMES:
        raise ValueError(
            f'Invalid model name {model_name}. Options: {MODEL_NAMES}')
    return ModelConfig.from_dict(
        EVO_1_131K_BASE if '131k' in model_name else EVO_1_8K_BASE)


class EvoModel:
    """Engine facade over a `model.StripedHyena` and its config; `mesh` is
    the module's."""

    def __init__(self, config: ModelConfig, module: model_lib.StripedHyena):
        self.config = config
        self.module = module
        self.mesh = module.mesh

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
        segmented loops pass it as they do in the JAX package. A cache
        whose offset is an int32 (B,) tensor of per-row offsets (the slot
        batch of `serving.py`) takes decode steps only: a length-1 input
        goes to `decode_step`, a longer one raises.

        donate_cache: the port updates the passed cache in place whether or
        not it is donated, and returns that same dict, so a caller that
        wants the old state clones it first. The keyword keeps the
        reference's routing: a donated length-1 input takes the prefill,
        not the decode step."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if ids.dim() == 1:
            ids = ids[None]
        if inference_params_dict is None:
            B = ids.shape[0]
            logits = model_lib.forward(self.module,
                                       shard_rows(ids, self.mesh))
            return gather_rows(logits, self.mesh, B), None
        per_row = isinstance(inference_params_dict['offset'], torch.Tensor)
        if ids.shape[1] == 1 and (per_row or not donate_cache):
            logits, cache = self.decode_step(ids[:, 0],
                                             inference_params_dict)
            return logits[:, None], cache
        if per_row:
            raise ValueError('a cache with per-row (B,) offsets takes '
                             'decode steps only, not a prefill')
        if resume is None:
            resume = inference_params_dict['offset'] > 0
        return self.prefill(ids, inference_params_dict, resume=bool(resume))

    def prefill(self, ids: torch.Tensor, cache, resume: bool = False):
        """`model.prefill` over the batch ids (B, L), split over dp."""
        logits, cache = model_lib.prefill(
            self.module, shard_rows(ids, self.mesh), cache, resume=resume)
        return gather_rows(logits, self.mesh, ids.shape[0]), cache

    def decode_step(self, token: torch.Tensor, cache):
        """`model.decode_step` for the batch's tokens (B,), split over
        dp."""
        logits, cache = model_lib.decode_step(
            self.module, shard_rows(token, self.mesh), cache)
        return gather_rows(logits, self.mesh, token.shape[0]), cache

    def initialize_inference_params(self, batch_size: int, max_len: int):
        """A zeroed cache for a batch of `batch_size` rows (this rank's
        part under a mesh)."""
        return model_lib.init_cache(self.config, batch_size, max_len,
                                    self.device, self.mesh)

    @property
    def num_params(self) -> int:
        return model_lib.param_count(self.module)


def load_checkpoint(
    model_name: str = 'evo-1-8k-base',
    checkpoint_path: Optional[str] = None,
    random_init: bool = False,
    seed: int = 0,
    config_overrides: Optional[Dict[str, Any]] = None,
    mesh=None,
    device: Union[str, torch.device] = 'cuda',
) -> Tuple[EvoModel, ModelConfig]:
    """Build an `EvoModel` on `device`.

    checkpoint_path: a native checkpoint directory of the port, or a
    reference safetensors snapshot, which is converted on the fly with its
    shapes as ground truth for the architecture fields. Without a path the
    published snapshot is fetched through `huggingface_hub`.
    random_init: random weights of the right schema, from `seed`.

    Under `weight_quant` the loaded (unquantized) weights are quantized
    layer by layer, each source weight freed as soon as its codes exist.

    mesh: a `parallel.mesh.Mesh`; every rank calls this with the same
    arguments and keeps its tensor-parallel shards, read (or drawn) whole
    one tensor at a time and sliced before they are quantized. int4 has no
    sharded layout and raises.
    """
    device = model_lib.resolve_device(device)
    config = config_for_model(model_name)
    if config_overrides:
        config = config.replace(**config_overrides)
    if config.weight_quant == 'int4' and mesh is not None:
        from evo_tpu_torch.quant import INT4_MESH_REFUSAL
        raise ValueError(INT4_MESH_REFUSAL)
    if config.act_quant == 'int8' and config.weight_quant != 'int8':
        raise ValueError('act_quant: int8 requires weight_quant: int8 (the '
                         'int8 x int8 product needs quantized weights; '
                         'evo_tpu_torch/quant.py)')
    if random_init:
        gen = torch.Generator(device=device).manual_seed(seed)
        module = model_lib.random_init(config, gen, device, mesh)
    else:
        if checkpoint_path is None:
            checkpoint_path = snapshot_download(model_name)
        from evo_tpu_torch import checkpoint as ckpt
        if ckpt.is_native_checkpoint(checkpoint_path):
            # the config saved WITH the checkpoint is ground truth for the
            # architecture fields; runtime fields stay as requested
            config = ckpt.reconcile_native_config(checkpoint_path, config)
            module = ckpt.load_params_auto(checkpoint_path, config, device,
                                           mesh)
        else:
            module, config = ckpt.load_reference_checkpoint_adaptive(
                checkpoint_path, config, device, mesh=mesh)
    if config.weight_quant != 'none':
        from evo_tpu_torch.quant import quantize_params
        module = quantize_params(module, free_source=True,
                                 mode=config.weight_quant)
    return EvoModel(config, module), config


def hf_revision(model_name: str) -> str:
    """The pinned snapshot revision: `1.1_fix` for the evo-1 base models,
    `main` otherwise."""
    return ('1.1_fix' if model_name in ('evo-1-8k-base', 'evo-1-131k-base')
            else 'main')


def snapshot_download(model_name: str) -> str:
    """Fetch the safetensors snapshot of `model_name`, or find it in the
    local HF cache, through `huggingface_hub`. Raises a clear error that
    points at `checkpoint_path=` and `random_init=True` when the package
    is missing, or the hub cannot be reached and nothing is cached."""
    repo = HF_MODEL_NAME_MAP[model_name]
    rev = hf_revision(model_name)
    try:
        from huggingface_hub import snapshot_download as hf_fetch
    except ImportError as e:
        raise RuntimeError(
            f'huggingface_hub is not installed; pass checkpoint_path= to a '
            f'local snapshot of {repo} (revision {rev}) or random_init=True.'
        ) from e
    try:
        return hf_fetch(repo, revision=rev)
    except Exception:
        # one retry against the local cache only (works fully offline)
        try:
            return hf_fetch(repo, revision=rev, local_files_only=True)
        except Exception as e:
            raise RuntimeError(
                f'Could not download {repo}@{rev} from the HuggingFace hub '
                f'and no cached copy exists. If this machine has no network '
                f'access, stage the snapshot manually and pass '
                f'checkpoint_path=<dir>, or use random_init=True for '
                f'schema-only runs.') from e


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
        if model_name not in MODEL_NAMES:
            raise ValueError(
                f'Invalid model name {model_name}. Options: {MODEL_NAMES}')
        self.model, self.config = load_checkpoint(
            model_name, checkpoint_path=checkpoint_path,
            random_init=random_init, seed=seed,
            config_overrides=config_overrides, mesh=mesh, device=device)
        self.device = self.model.device
        self.tokenizer = CharLevelTokenizer(512)
