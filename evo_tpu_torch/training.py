"""Training: next-token loss, AdamW on float32 masters, the train step and
train-state files (port of `evo_tpu/training.py`).

Precision, as in the JAX package: the `TrainState` holds float32 MASTER
copies of the parameters; the forward and backward run on the model's own
parameters in their types (bf16 on the card; the poles and residues stay
float32), into which the masters are cast at the start of a step, as the
JAX package casts them inside its loss. The gradients are upcast into the
masters' `.grad`, which is the same arithmetic as the VJP of that cast, and
the update runs in float32: global-norm clipping, Adam with float32
moments, decoupled weight decay, the learning rate. The updated masters
are copied back into the model, so it serves the trained weights between
steps. Without masters, bf16 weights at fine-tuning learning rates
(~1e-4) round most updates to zero.

Kernels: a training forward on the card runs RMSNorm, FIR + gate and
causal flash attention as CUDA kernels with gradients (`ops/_grad.py`);
the train steps turn off `hyena_fused_mixer` and `hyena_pallas_prefix`,
whose kernels have no backward, as `use_pallas='never'` turns them off in
the JAX package, and refuse quantized weights and activations.

The optax chain of the JAX package (`clip_by_global_norm`, `scale_by_adam`,
`add_decayed_weights` under the decay mask, `scale_by_learning_rate`) is
`Optimizer`: the clip written as optax writes it, then
`torch.optim.AdamW` over two parameter groups (decay and no decay), whose
decoupled decay `p * (1 - lr * wd)` is optax's decayed weights scaled by
the learning rate. The schedule is a function of the step; the first
update uses lr(0), as optax's count starts at 0.

Train-state files are the port's own: safetensors of the masters and both
moments plus a JSON of the step and the hyperparameters (one file pair a
rank under a mesh, the mesh's shape in the JSON). The port reads no orbax
directory (the JAX package's format) and says so.

`make_sharded_train_step` is full fine-tuning over a (dp, cp, tp) mesh
(`parallel/`): each rank keeps float32 masters and both moments of its
tp shards only, takes its dp rank's rows of the batch, and the layers'
collectives carry the tensor- and context-parallel forward and backward.
Under cp each rank's loss sums the next-token terms of its rows of the
sequence (`model.forward_rows`: no gather of the logits), divided by the
whole batch's count. The master gradients are summed over cp, then over
dp, per tensor (one flat float32 buffer of 1.82 B parameters would be
7.3 GB a rank), so that every rank's sum is the JAX package's gradient of
the mean; the global-norm clip is taken over the whole logical tree (the
squares of tp-sharded gradients summed over tp, replicated ones counted
once) and AdamW steps each rank's shards.

The full train step's AdamW runs tensor by tensor (`foreach=False`):
torch's for-each update would hold one more float32 copy of every
moment while it runs (6.8 GiB at 1.82 B parameters), the peak of a full
step. LoRA's adapters are small and keep the for-each update.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

from evo_tpu_torch import model as model_lib
from evo_tpu_torch.config import ModelConfig
from evo_tpu_torch.parallel.collectives import all_reduce_sum
from evo_tpu_torch.parallel.sharding import tp_axis
from evo_tpu_torch.quant import QuantizedWeight

Schedule = Callable[[int], float]
STATE_DIR = 'train_state'
_TENSORS = 'train_state.safetensors'
_META = 'train_state.json'


def module_of(model) -> model_lib.StripedHyena:
    """The `StripedHyena` of an `EvoModel` (or the module itself)."""
    return getattr(model, 'module', model)


def next_token_loss(model, cfg: Optional[ModelConfig], ids,
                    loss_mask=None, count=None) -> torch.Tensor:
    """Mean next-token cross-entropy.

    ids: (B, L) integer. Position t's logits predict ids[:, t+1].
    loss_mask: (B, L) {0, 1} over *target* positions (mask[:, t] gates the
    prediction of ids[:, t]); None = every position after the first counts.
    Padding convention as in scoring: right-padded, no attention mask,
    correctness from masking the loss only. `cfg`: the config to run the
    forward under (None: the model's own). `count`: the divisor, the
    mask's own sum by default (a dp rank passes the whole batch's).

    Under cp (the model's mesh) it is this cp rank's share: the terms of
    the positions whose logits the rank holds (`model.forward_rows`; the
    last position and the padding dropped) over the whole sequence's
    count, so that the sum over cp is the mean. The train steps sum it;
    the gradient of each share is the rank's, and the collectives'
    adjoints add the shares' terms once each."""
    module = module_of(model)
    ids = torch.as_tensor(ids, device=module.device).long()
    mask = (torch.ones(tuple(ids.shape), device=module.device)
            if loss_mask is None else torch.as_tensor(
                loss_mask, device=module.device).to(torch.float32))
    if count is None:
        count = torch.sum(mask[:, 1:])
    logits, start = model_lib.forward_rows(module, ids, cfg)
    # the rows' positions that predict a token of the sequence
    stop = max(start, min(start + logits.shape[1], ids.shape[1] - 1))
    logp = torch.log_softmax(logits[:, :stop - start].float(), dim=-1)
    nll = -torch.gather(logp, -1, ids[:, start + 1:stop + 1, None])[..., 0]
    return (torch.sum(nll * mask[:, start + 1:stop + 1])
            / torch.clamp(count, min=1.0))


def scored_positions(module, ids, loss_mask=None) -> torch.Tensor:
    """The number of target positions of a batch that the loss scores
    (float32, on the module's device): a dp rank's share of the divisor
    of a sharded step's loss."""
    mask = (torch.ones(tuple(ids.shape), device=module.device)
            if loss_mask is None else torch.as_tensor(
                loss_mask, device=module.device).float())
    return mask[:, 1:].sum()


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # float32 masters by parameter name
    opt_state: torch.optim.Optimizer    # AdamW over the masters
    step: int


def decay_mask(params: Dict[str, torch.Tensor],
               cfg: Optional[ModelConfig] = None) -> Dict[str, bool]:
    """The AdamW decay mask of the JAX package, by parameter name: tensors
    of two or more axes decay; 1-D ones (biases, norm gains) and the
    pretrained modal poles and residues never do (decaying the dynamics
    toward zero corrupts the filters even with no gradient signal).

    The JAX package stacks each run of Hyena layers along a leading layer
    axis and counts that axis: there a Hyena block's 1-D gains and biases
    are 2-D and decay. With `cfg`, the port counts it too, so both
    packages decay the same tensors; names are those of
    `named_parameters()` ('blocks.<i>.<module>.<name>') or of
    `lora.named_adapters`."""
    mask = {}
    for name, t in params.items():
        parts = name.split('.')
        stacked = (cfg is not None and parts[0] == 'blocks'
                   and not cfg.is_attn_layer(int(parts[1])))
        mask[name] = (t.dim() + stacked >= 2
                      and parts[-1] not in ('poles', 'residues'))
    return mask


def warmup_cosine(peak_lr: float, total_steps: int,
                  warmup_steps: Optional[int] = None,
                  end_lr_frac: float = 0.1) -> Schedule:
    """Linear warmup from 0 to `peak_lr` over `warmup_steps` (default:
    total_steps/10, capped at 100), then cosine decay to `end_lr_frac *
    peak_lr` at `total_steps`: optax's `warmup_cosine_decay_schedule` as a
    function of the step count (0 at the first update)."""
    if warmup_steps is None:
        warmup_steps = min(100, max(1, total_steps // 10))
    warmup_steps = min(warmup_steps, max(total_steps - 1, 1))
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError('warmup_cosine needs total_steps > warmup_steps, '
                         f'got {total_steps} and {warmup_steps}')
    end_lr = end_lr_frac * peak_lr
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (0.0 - peak_lr) * frac + peak_lr
        t = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)
    return schedule


def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """optax's `clip_by_global_norm`, in place: every g becomes
    (g / ||g||) * max_norm when the global norm ||g|| is max_norm or more,
    with no epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6 and would
    not match). Chosen on the device, with no read back. Returns ||g||.
    `norm`: ||g|| of a larger tree that grads are part of (a sharded
    step's), computed by the caller."""
    grads = [g for g in grads if g is not None]
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                              for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The JAX package's optimizer chain (`make_optimizer`): global-norm
    clipping, Adam (b1, b2, eps 1e-8) with float32 moments, weight decay
    under `decay_mask`, the learning rate (a float or a schedule of the
    step). `init` builds the `torch.optim.AdamW` over a dict of masters;
    `update` takes one step with the masters' `.grad`."""

    learning_rate: Union[float, Schedule] = 1e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step) if callable(lr) else lr)

    def init(self, params: Dict[str, torch.Tensor],
             cfg: Optional[ModelConfig] = None,
             foreach: Optional[bool] = None) -> torch.optim.AdamW:
        """`foreach`: torch's choice of the update's implementation (None:
        its default; False: tensor by tensor, with no temporary the size
        of all the moments)."""
        mask = decay_mask(params, cfg)
        groups = [{'params': [t for n, t in params.items() if mask[n]],
                   'weight_decay': self.weight_decay},
                  {'params': [t for n, t in params.items() if not mask[n]],
                   'weight_decay': 0.0}]
        return torch.optim.AdamW([g for g in groups if g['params']],
                                 lr=self.lr(0), betas=(self.b1, self.b2),
                                 eps=1e-8, foreach=foreach)

    def update(self, opt: torch.optim.AdamW,
               params: Dict[str, torch.Tensor], step: int,
               norm: Optional[torch.Tensor] = None) -> None:
        """Clip the masters' gradients (by `norm` where given, see
        `clip_by_global_norm_`), set the learning rate of `step` (counted
        from 0) and take one AdamW step."""
        clip_by_global_norm_([t.grad for t in params.values()],
                             self.grad_clip, norm)
        lr = self.lr(step)
        for group in opt.param_groups:
            group['lr'] = lr
        opt.step()


def make_optimizer(learning_rate: Union[float, Schedule] = 1e-4,
                   weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: float = 1.0) -> Optimizer:
    """AdamW with global-norm clipping, weight decay masked as
    `decay_mask` says. learning_rate: a float or a schedule of the step,
    e.g. `warmup_cosine(...)`."""
    return Optimizer(learning_rate, weight_decay, b1, b2, grad_clip)


def serving_params(state: TrainState, model) -> Dict[str, torch.Tensor]:
    """The masters cast back to the types of the model's parameters."""
    params = dict(module_of(model).named_parameters())
    return {n: m.to(params[n].dtype) for n, m in state.params.items()}


def load_masters(model, state: TrainState) -> None:
    """Cast the masters into the model's parameters, in place."""
    with torch.no_grad():
        for n, p in module_of(model).named_parameters():
            p.copy_(state.params[n])


def init_train_state(model, optimizer: Optimizer) -> TrainState:
    """float32 masters of every parameter of `model` (copies, also of the
    float32 poles and residues) and the optimizer over them."""
    module = module_of(model)
    masters = {n: p.detach().to(torch.float32, copy=True)
               for n, p in module.named_parameters()}
    return TrainState(masters, optimizer.init(masters, module.config,
                                              foreach=False), 0)


def train_config(model, adapters: bool = False) -> ModelConfig:
    """The config a train step runs under: the model's own with the
    kernels that have no backward turned off (`hyena_fused_mixer`,
    `hyena_pallas_prefix`, as `use_pallas='never'` does in the JAX
    package). Raises on quantized weights or activations."""
    module = module_of(model)
    cfg = module.config
    quantized = cfg.act_quant != 'none' or any(
        isinstance(m, QuantizedWeight) for m in module.modules())
    if quantized and adapters:
        raise NotImplementedError(
            'LoRA over int8 / int4 base weights is not ported yet '
            '(ROADMAP.md, modules queue: LoRA over a quantized base)')
    if quantized:
        raise ValueError('full fine-tuning trains float weights: load the '
                         'model without weight_quant / act_quant')
    return cfg.replace(hyena_fused_mixer=False, hyena_pallas_prefix=False)


def set_trainable(tensors, on: bool) -> None:
    for t in tensors:
        t.requires_grad_(on)


def make_train_step(model, optimizer: Optimizer
                    ) -> Callable[..., tuple]:
    """step(state, ids, loss_mask=None) -> (state', loss) for full
    fine-tuning of `model` (an `EvoModel` or a `StripedHyena`): the
    masters are cast into the model's parameters, the loss and its
    gradients run there, the gradients are upcast into the masters'
    `.grad`, AdamW steps the masters and they are copied back. The
    parameters require grad only inside a step."""
    module = module_of(model)
    if module.mesh is not None:
        raise ValueError('the model is sharded over a mesh: use '
                         'make_sharded_train_step(model, optimizer, mesh)')
    return _train_step(module, optimizer, None)


def _train_step(module, optimizer: Optimizer, mesh):
    cfg = train_config(module)
    params = dict(module.named_parameters())
    sharded = {n for n in params if mesh is not None and mesh.tp > 1
               and tp_axis(n) is not None}

    def global_norm(masters):
        """||g|| over the logical tree: the squares of tp-sharded
        gradients summed over tp, replicated ones (the same on every tp
        rank) counted once."""
        def sq(names):
            return sum((torch.sum(masters[n].grad * masters[n].grad)
                        for n in names), torch.zeros((), device=module.device))
        return torch.sqrt(all_reduce_sum(sq(sharded), mesh)
                          + sq([n for n in masters if n not in sharded]))

    # the axes a gradient and the loss are summed over: a cp rank's loss
    # is its rows' share, a dp rank's its rows'
    axes = [a for a in ('cp', 'dp') if mesh is not None and mesh.shape[a] > 1]

    def train_step(state: TrainState, ids, loss_mask=None):
        load_masters(module, state)
        count = None
        if 'dp' in axes:
            # the whole batch's count of scored positions, so that the
            # sum of the dp ranks' losses is the global mean
            count = all_reduce_sum(scored_positions(module, ids, loss_mask),
                                   mesh, 'dp')
        set_trainable(params.values(), True)
        try:
            loss = next_token_loss(module, cfg, ids, loss_mask, count)
            loss.backward()
        finally:
            set_trainable(params.values(), False)
        for n, p in params.items():
            m = state.params[n]
            m.grad = (torch.zeros_like(m) if p.grad is None
                      else p.grad.to(torch.float32))
            p.grad = None
            for axis in axes:
                m.grad = all_reduce_sum(m.grad, mesh, axis)
        norm = None if mesh is None else global_norm(state.params)
        optimizer.update(state.opt_state, state.params, state.step, norm)
        for m in state.params.values():
            m.grad = None
        load_masters(module, state)
        loss = loss.detach()
        for axis in axes:
            loss = all_reduce_sum(loss, mesh, axis)
        return (TrainState(state.params, state.opt_state, state.step + 1),
                loss)

    return train_step


def make_sharded_train_step(model, optimizer: Optimizer, mesh):
    """step(state, ids, loss_mask=None) -> (state', loss) for full
    fine-tuning of a model sharded over `mesh` (built with `mesh=`; any
    (dp, cp, tp); see the module docstring). Every rank calls the step;
    ids and loss_mask are this dp rank's rows of the global batch, whole
    sequences (each tp and cp rank of a dp group passes the same rows; the
    model splits them over cp itself), and the loss returned on every
    rank is the global batch's. `init_train_state(model, optimizer)`
    makes each rank's masters of its shards."""
    module = module_of(model)
    if module.mesh is not mesh:
        raise ValueError('make_sharded_train_step: the model was not built '
                         'on this mesh (pass mesh= when loading it)')
    return _train_step(module, optimizer, mesh)


# ---------------------------------------------------------------------------
# Train-state files (the port's own format)
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = '') -> Dict[str, torch.Tensor]:
    """Tensors of a dict / list tree by dotted path ('0.mlp.w1.a'); a flat
    dict of names keeps its names."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten(v, f'{prefix}.{k}' if prefix else str(k)))
    return out


def _files(mesh) -> tuple:
    """(tensors, JSON) file names: one pair, or one pair a rank."""
    if mesh is None:
        return _TENSORS, _META
    stem = f'train_state.rank{mesh.rank}'
    return stem + '.safetensors', stem + '.json'


def _mesh_shape(mesh) -> Optional[dict]:
    return None if mesh is None else dict(mesh.shape)


def save_train_state(state, path: str, mesh=None) -> None:
    """Write a `TrainState` or `lora.LoraTrainState` under
    `<path>/train_state/`: the masters and both Adam moments as
    safetensors, the step, each tensor's Adam count and the
    hyperparameters as JSON. Under a mesh every rank writes its own pair
    (`train_state.rank<r>.*`), with the mesh's shape in the JSON."""
    from evo_tpu_torch.checkpoint import _write_safetensors_file
    params, opt, step = state
    d = os.path.join(os.path.abspath(path), STATE_DIR)
    os.makedirs(d, exist_ok=True)
    tensors_file, meta_file = _files(mesh)
    tensors, counts = {}, {}
    for name, t in flatten(params).items():
        tensors['params/' + name] = t
        st = opt.state.get(t)
        if st:
            tensors['exp_avg/' + name] = st['exp_avg']
            tensors['exp_avg_sq/' + name] = st['exp_avg_sq']
            counts[name] = float(st['step'])
    _write_safetensors_file(tensors, os.path.join(d, tensors_file))
    group = opt.param_groups[0]
    meta = {'format': 'evo_tpu_torch_train_state', 'version': 1,
            'step': int(step), 'adam_counts': counts,
            'mesh': _mesh_shape(mesh),
            'hyperparameters': {'lr': group['lr'], 'betas': group['betas'],
                                'eps': group['eps'],
                                'weight_decay': [g['weight_decay'] for g in
                                                 opt.param_groups]}}
    with open(os.path.join(d, meta_file), 'w') as f:
        json.dump(meta, f, indent=1)


def load_train_state(path: str, template, mesh=None):
    """Restore a train state written by `save_train_state` into
    `template` (a state of the same structure, e.g. from
    `init_train_state`): its tensors and optimizer are filled in place and
    it comes back with the saved step. Under a mesh each rank reads its
    own pair; a state saved under another mesh shape, or with and without
    one, raises."""
    from evo_tpu_torch.checkpoint import _read_safetensors_file
    d = os.path.join(os.path.abspath(path), STATE_DIR)
    tensors_file, meta_file = _files(mesh)
    if not os.path.exists(os.path.join(d, meta_file)):
        other = sorted(n for n in os.listdir(d) if n.endswith('.json')) \
            if os.path.isdir(d) else []
        raise ValueError(
            f'{d} holds no train state of evo_tpu_torch for mesh '
            f'{_mesh_shape(mesh)} ({meta_file} missing; found {other}); an '
            'orbax train state of the JAX package is not read here')
    with open(os.path.join(d, meta_file)) as f:
        meta = json.load(f)
    if meta.get('mesh') != _mesh_shape(mesh):
        raise ValueError(f'{d} was saved under mesh {meta.get("mesh")}, '
                         f'not {_mesh_shape(mesh)}: load it on the mesh it '
                         'was saved from')
    saved = _read_safetensors_file(os.path.join(d, tensors_file))
    params, opt, _ = template
    for name, t in flatten(params).items():
        src = saved.get('params/' + name)
        if src is None or tuple(src.shape) != tuple(t.shape):
            raise ValueError(f'train state tensor {name!r}: saved '
                             f'{None if src is None else tuple(src.shape)}'
                             f', template {tuple(t.shape)}')
        with torch.no_grad():
            t.copy_(src)
        if name in meta['adam_counts']:
            opt.state[t] = {
                'step': torch.tensor(meta['adam_counts'][name],
                                     dtype=torch.float32),
                'exp_avg': saved['exp_avg/' + name].to(t.device, copy=True),
                'exp_avg_sq': saved['exp_avg_sq/' + name].to(t.device,
                                                             copy=True)}
    return type(template)(params, opt, meta['step'])
