"""One rank of the context-parallel training smoke run on the card.

    python -m evo_tpu_torch.tools.cp_train_smoke {model,small} <dir>

launched as two ranks with torchrun's environment (`parallel.distributed.
launch_local` does that). The ranks join over gloo, chosen explicitly, so
that both may share one card (NCCL refuses that), and make one cp = 2 mesh:
each rank holds the whole weights (and the whole masters and moments),
its half of the sequence in the residual stream, and half of the channels
and heads inside the mixers. `small` reads `<dir>/small_in.pt` (a small
config, ids and mask; `part_small`). `model` reads `<dir>/cp_train_in.json`
(the corpus) and `<dir>/cp_train_ref.pt` (the single process's probed
gradients on the same weights and batches) and writes `<dir>/
cp_train_rank<r>.json`:

  (a) full fine-tuning of the first 9 layers of evo-1-8k-base (seed 20)
      at full width, a window of L = 2,048: 1 step under Ulysses, then a
      ragged L = 2,049 under Ulysses with remat, each leg from the seed's
      weights and fresh AdamW state;
  (b) LoRA rank 8 on the seven default targets of the same 9 layers at
      L = 4,096 with remat: 2 steps under Ulysses, 1 under 'ring' and 1
      under 'zigzag', each leg from the same fresh adapters. The rings
      run under LoRA, whose gradient sum is the adapters' alone: a full
      step's sum of 1.8 G float32 gradients took 9-20 s through gloo.

For each leg: the losses, s a step, the first step's gradients of the
probed tensors as the step sums them (`Recording`), replicated masters or
adapters bit-equal across the ranks after each step (`fingerprint`), the
launches of kernels 1-3, peak GiB, and the time in the cp collectives
between device syncs (`cp_smoke.timed_collectives`): the forward's, the
backward's (the remat recompute's included) and the gradient sum's apart.

Times are taken with both ranks on one card over gloo, whose all-to-alls,
sends and reduces pass through host memory: they say what this run took,
nothing of NCCL or of cp across cards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict

import torch

from evo_tpu_torch import training
from evo_tpu_torch.tools.cp_smoke import timed_collectives

# the tensors whose first-step gradient the card run compares with the
# single process's: layer 0's in-projection, the attention's (layer 8)
# QKV projection, the final norm; under LoRA the B factors of the first
# two (the A factors' gradients are 0 at fresh adapters)
FULL_PROBES = ('blocks.0.hyena.w_in', 'blocks.8.attn.wqkv',
               'final_norm.weight')
LORA_PROBES = ('blocks.0.hyena.w_in.b', 'blocks.8.attn.wqkv.b')


@dataclasses.dataclass(frozen=True)
class Recording(training.Optimizer):
    """The train steps' optimizer, keeping float32 copies of the gradients
    it is given at its first update: summed over the mesh as the step sums
    them, before the clip. `names`: the tensors to keep (all by
    default)."""

    names: tuple = ()
    grads: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def update(self, opt, params, step, norm=None) -> None:
        if not self.grads:
            for n in (self.names or tuple(params)):
                self.grads[n] = params[n].grad.detach().float().clone()
        super().update(opt, params, step, norm)


def fingerprint(tensors) -> torch.Tensor:
    """An exact integer fingerprint a tensor (int64, on the host): the sum
    of its elements' bit patterns as int32 words. Two tensors that differ
    in any bit differ here but for a cancellation no rounding produces."""
    out = []
    for t in tensors:
        words = t.detach().contiguous().view(-1).view(torch.int32)
        out.append(words.sum(dtype=torch.int64))
    return torch.stack(out).cpu()


def equal_across(tensors, mesh, axis: str = 'cp') -> bool:
    """Whether every rank of `axis` holds bit-equal tensors (by
    `fingerprint`, gathered on the host)."""
    from evo_tpu_torch.parallel.collectives import gather_cpu
    parts = gather_cpu(fingerprint(tensors), mesh, axis)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _sync_time(fn):
    """(s of fn() between device syncs, its result)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def _distances(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """||g - ref|| / ||ref|| of each probed gradient (Frobenius, float64)."""
    out = {}
    for n, want in ref.items():
        want = want.to(grads[n].device, torch.float64)
        out[n] = float((grads[n].double() - want).norm() / want.norm())
    return out


def _batch(corpus: str, seq_len: int):
    """The first window of `seq_len` + 1 tokens the packed loader gives
    (seed 0), as phases 19 and 20 of chip_smoke.py take theirs."""
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    ds = PackedFastaDataset([corpus], CharLevelTokenizer(512),
                            seq_len=seq_len, batch_size=1, seed=0)
    return next(ds.iter_batches())


def nine_layers():
    """The first 9 layers of evo-1-8k-base at full width (8 Hyena layers
    and the attention layer at 8), as phase 20 of chip_smoke.py trains."""
    from evo_tpu_torch.models import config_for_model
    return config_for_model('evo-1-8k-base').replace(
        num_layers=9, attn_layer_idxs=(8,), hyena_layer_idxs=())


# (name, cp_attn, seq_len of the packed window, remat, steps, the single
# process's reference: '_plain' where the rings' float32 core stands for
# kernel 3 there too)
FULL_LEGS = (('ulysses', 'ulysses', 2047, False, 1, 'full_2048'),
             ('ragged', 'ulysses', 2048, True, 1, 'full_2049'))
LORA_LEGS = (('ulysses', 'ulysses', 2, 'lora'),
             ('ring', 'ring', 1, 'lora_plain'),
             ('zigzag', 'zigzag', 1, 'lora_plain'))
LORA_SEQ_LEN = 4095
FULL_SEED, LORA_SEED = 20, 24


def part_full(inp: dict, ref: dict, mesh) -> dict:
    """(a): each leg from the seed's weights (the same on every rank) and
    fresh masters and moments."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.ops import _build
    res = {}
    for name, attn, seq_len, remat, steps, key in FULL_LEGS:
        ids, mask = _batch(inp['corpus'], seq_len)
        cfg = nine_layers().replace(cp_attn=attn, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        module = model_lib.random_init(
            cfg, torch.Generator(device='cuda').manual_seed(FULL_SEED),
            'cuda', mesh)
        opt = Recording(learning_rate=1e-4, names=FULL_PROBES)
        state = training.init_train_state(module, opt)
        step = training.make_sharded_train_step(module, opt, mesh)
        _build.LAUNCHES.clear()
        leg = dict(losses=[], step_s=[], replicated_equal=[])
        spent: Dict[str, float] = {}
        for _ in range(steps):
            with timed_collectives(spent):
                secs, (state, loss) = _sync_time(
                    lambda: step(state, ids, mask))
            leg['losses'].append(float(loss))
            leg['step_s'].append(secs)
            leg['replicated_equal'].append(
                equal_across(list(state.params.values()), mesh))
        leg.update(launches=dict(_build.LAUNCHES), collectives_ms=spent,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   seq_len=int(ids.shape[1]),
                   grad_dist=_distances(opt.grads, ref[key]))
        res[name] = leg
        del module, opt, state, step
    torch.cuda.empty_cache()
    return res


def part_lora(inp: dict, ref: dict, mesh) -> dict:
    """(b): each leg from the same fresh adapters over the seed's base."""
    from evo_tpu_torch import lora
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.ops import _build
    ids, mask = _batch(inp['corpus'], LORA_SEQ_LEN)
    torch.cuda.reset_peak_memory_stats()
    module = model_lib.random_init(
        nine_layers().replace(remat=True),
        torch.Generator(device='cuda').manual_seed(FULL_SEED), 'cuda', mesh)
    base = fingerprint(list(module.parameters()))
    res = {}
    for name, attn, steps, key in LORA_LEGS:
        module.config = module.config.replace(cp_attn=attn)
        adapters = lora.init_lora(
            torch.Generator(device='cuda').manual_seed(LORA_SEED), module,
            rank=8)
        opt = Recording(learning_rate=1e-3, names=LORA_PROBES)
        state = lora.init_lora_train_state(adapters, opt)
        step = lora.make_lora_train_step(module, opt, alpha=16.0)
        _build.LAUNCHES.clear()
        leg = dict(losses=[], step_s=[], replicated_equal=[])
        spent: Dict[str, float] = {}
        for _ in range(steps):
            with timed_collectives(spent):
                secs, (state, loss) = _sync_time(
                    lambda: step(state, ids, mask))
            leg['losses'].append(float(loss))
            leg['step_s'].append(secs)
            leg['replicated_equal'].append(equal_across(
                list(lora.named_adapters(state.lora).values()), mesh))
        leg.update(launches=dict(_build.LAUNCHES), collectives_ms=spent,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   seq_len=int(ids.shape[1]),
                   base_unchanged=bool(torch.equal(
                       fingerprint(list(module.parameters())), base)),
                   grad_dist=_distances(opt.grads, ref[key]))
        res[name] = leg
        del adapters, opt, state, step
    del module
    torch.cuda.empty_cache()
    return res


def part_small(d: str, mesh) -> None:
    """One sharded step of a small bf16 config under 'ulysses' and under
    'zigzag', each from the seed's weights: the loss, every gradient as
    the step sums it and the launches, to `<dir>/small_<mode>_rank<r>.pt`
    (a test's probe)."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.ops import _build
    inp = torch.load(os.path.join(d, 'small_in.pt'))
    for mode in ('ulysses', 'zigzag'):
        cfg = tiny_config(**inp['config']).replace(cp_attn=mode)
        module = model_lib.random_init(
            cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda', mesh)
        opt = Recording(learning_rate=1e-4)
        step = training.make_sharded_train_step(module, opt, mesh)
        _build.LAUNCHES.clear()
        _, loss = step(training.init_train_state(module, opt), inp['ids'],
                       inp['mask'])
        torch.save({'loss': float(loss), 'launches': dict(_build.LAUNCHES),
                    'grads': {n: g.cpu() for n, g in opt.grads.items()}},
                   os.path.join(d, f'small_{mode}_rank{mesh.rank}.pt'))


def main(argv=None) -> int:
    part, d = (argv or sys.argv[1:])[:2]
    from evo_tpu_torch.parallel.distributed import initialize_distributed
    from evo_tpu_torch.parallel.mesh import make_mesh
    initialize_distributed(backend='gloo', device='cuda')
    mesh = make_mesh(dp=1, cp=2)
    if part == 'small':
        part_small(d, mesh)
    else:
        with open(os.path.join(d, 'cp_train_in.json')) as f:
            inp = json.load(f)
        ref = torch.load(os.path.join(d, 'cp_train_ref.pt'))
        t = time.time()
        res = {'full': part_full(inp, ref, mesh)}
        res['full_seconds'] = time.time() - t
        t = time.time()
        res['lora'] = part_lora(inp, ref, mesh)
        res['lora_seconds'] = time.time() - t
        with open(os.path.join(d, f'cp_train_rank{mesh.rank}.json'),
                  'w') as f:
            json.dump(res, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
