"""CLI: FASTA corpus -> fine-tuned Evo checkpoint (the flags, defaults and
outputs of the JAX package's `scripts/finetune.py`).

    python -m evo_tpu_torch.cli.finetune --input-fasta corpus.fasta \
        --save-dir ft --lora-rank 8

Wires the packed-FASTA batches (`io/dataset.py`) into the train step of
`training.py` (full fine-tuning on float32 masters) or, with
`--lora-rank`, of `lora.py`, and writes

  * `<save-dir>/train_state/`: the port's train state (masters or
    adapters, both Adam moments, the step), read back by `--resume`;
  * `<save-dir>/adapters.npz` (LoRA): the adapters in the JAX package's
    npz layout;
  * `<save-dir>/serving/`: a native serving checkpoint (bf16 weights,
    float32 poles and residues; the adapters merged under LoRA), loadable
    with `Evo(..., checkpoint_path=<save-dir>/serving)`.

`--device` defaults to `cuda`; `--tiny --device cpu` trains a tiny model
of the same schema on the CPU (example_seqs.fasta is ~50 tokens, so
--seq-len must be small enough to cut --batch-size windows an epoch).

`--dp D --tp T` fine-tunes over D x T ranks, launched one rank a card as
torchrun launches them (`--dist-backend gloo` for several ranks on one
card): the whole model by `training.make_sharded_train_step`, or with
`--lora-rank` the adapters by `lora.make_lora_train_step` (whole on
every rank, summed over tp and dp), each rank writing its own
train-state files; rank 0 writes `adapters.npz`, and the serving
checkpoint (the adapters merged into each shard first) is gathered with
`sharding.unshard` and written by rank 0. --batch-size keeps the JAX
script's meaning, the windows a host reads a step (there, one process
drives a host), so the global batch is --batch-size times the hosts,
whatever D is: each dp rank reads its share of it (`rank_batch_size`),
from the records of its dp coordinate (the dataset split D ways where
the JAX script splits it over hosts), and the rate printed is a host's.
The JAX script has no `--cp`, and the train steps refuse a
context-parallel mesh.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import torch

from evo_tpu_torch import checkpoint as ckpt
from evo_tpu_torch import lora as lora_lib
from evo_tpu_torch import training
from evo_tpu_torch.cli.score import start_ranks
from evo_tpu_torch.config import cli_tiny_overrides
from evo_tpu_torch.io.dataset import PackedFastaDataset
from evo_tpu_torch.models import Evo


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='Fine-tune Evo on FASTA (PyTorch / CUDA).')
    p.add_argument('--input-fasta', action='append', required=True,
                   help='training FASTA (repeatable; .gz supported)')
    p.add_argument('--model-name', default='evo-1-8k-base')
    p.add_argument('--device', default='cuda',
                   help='where the model trains: cuda (default) or cpu')
    p.add_argument('--checkpoint-path', default=None)
    p.add_argument('--random-init', action='store_true')
    p.add_argument('--tiny', action='store_true',
                   help='tiny same-schema model (CPU smoke; implies '
                        '--random-init)')
    p.add_argument('--seq-len', type=int, default=8192)
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--lr-schedule', choices=('constant', 'cosine'),
                   default='cosine',
                   help='cosine: linear warmup to --lr then cosine decay '
                        'to --end-lr-frac * lr at --steps')
    p.add_argument('--warmup-steps', type=int, default=None,
                   help='default: steps/10, capped at 100')
    p.add_argument('--end-lr-frac', type=float, default=0.1)
    p.add_argument('--weight-decay', type=float, default=0.01)
    p.add_argument('--grad-clip', type=float, default=1.0)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--dp', type=int, default=1,
                   help='data-parallel size (ranks that split the batches)')
    p.add_argument('--tp', type=int, default=None,
                   help='tensor-parallel size (ranks that shard the model)')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='torch.distributed backend (default: nccl on the '
                        'card, gloo on the CPU)')
    p.add_argument('--lora-rank', type=int, default=0,
                   help='>0 trains rank-r LoRA adapters (lora.py) over '
                        'the frozen base weights: the one-card 7B '
                        'fine-tune (~12.9 GB resident against ~84 GB for '
                        'full float32-master AdamW)')
    p.add_argument('--lora-alpha', type=float, default=16.0)
    p.add_argument('--lora-targets', default=None,
                   help='comma list of adapted weights (default: all of '
                        'w1,w2,w3,wqkv,wo,w_in,w_out)')
    p.add_argument('--no-remat', action='store_true',
                   help='disable per-block recomputation (more memory, '
                        'a faster backward)')
    p.add_argument('--save-dir', required=True)
    p.add_argument('--save-every', type=int, default=0,
                   help='checkpoint every N steps (0 = only at the end)')
    p.add_argument('--resume', action='store_true',
                   help='resume the optimizer and step from '
                        'save-dir/train_state')
    p.add_argument('--log-every', type=int, default=10)
    return p


def rank_batch_size(batch_size: int, mesh, hosts: int = 1) -> int:
    """Windows a dp rank reads a step when each of `hosts` hosts reads
    `batch_size` (the JAX script's per-process batch): the global batch
    split over the mesh's dp ranks, which must divide it."""
    dp = 1 if mesh is None else mesh.dp
    total = batch_size * hosts
    if total % dp:
        raise ValueError(f'--batch-size {batch_size} on {hosts} host(s) '
                         f'is a global batch of {total}, which --dp {dp} '
                         'does not divide')
    return total // dp


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    mesh, rows = None, args.batch_size
    if start_ranks(args):
        from evo_tpu_torch.parallel.distributed import get_world_size
        from evo_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp, tp=args.tp)
        world = get_world_size()
        hosts = world // int(os.environ.get('LOCAL_WORLD_SIZE', world))
        rows = rank_batch_size(args.batch_size, mesh, hosts)
    lead = mesh is None or mesh.rank == 0
    overrides = {'remat': not args.no_remat}
    if args.tiny:
        args.random_init = True
        overrides.update(cli_tiny_overrides())
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init, config_overrides=overrides,
              mesh=mesh)
    cfg = evo.config

    if args.lr_schedule == 'cosine':
        lr = training.warmup_cosine(args.lr, total_steps=args.steps,
                                    warmup_steps=args.warmup_steps,
                                    end_lr_frac=args.end_lr_frac)
    else:
        lr = args.lr
    optimizer = training.make_optimizer(
        learning_rate=lr, weight_decay=args.weight_decay,
        grad_clip=args.grad_clip)
    lora = args.lora_rank > 0
    if lora:
        targets = (tuple(t.strip() for t in args.lora_targets.split(','))
                   if args.lora_targets else lora_lib.DEFAULT_TARGETS)
        adapters = lora_lib.init_lora(
            torch.Generator(device=evo.device).manual_seed(args.seed),
            evo.model, rank=args.lora_rank, targets=targets)
        state = lora_lib.init_lora_train_state(adapters, optimizer)
        step_fn = lora_lib.make_lora_train_step(evo.model, optimizer,
                                                alpha=args.lora_alpha)
    elif mesh is not None:
        state = training.init_train_state(evo.model, optimizer)
        step_fn = training.make_sharded_train_step(evo.model, optimizer,
                                                   mesh)
    else:
        state = training.init_train_state(evo.model, optimizer)
        step_fn = training.make_train_step(evo.model, optimizer)
    if args.resume and os.path.exists(
            os.path.join(args.save_dir, training.STATE_DIR)):
        state = training.load_train_state(args.save_dir, state, mesh)
        print(f'resumed at step {state.step}', flush=True)

    ds = PackedFastaDataset(
        args.input_fasta, evo.tokenizer, seq_len=args.seq_len,
        batch_size=rows, seed=args.seed,
        process_index=0 if mesh is None else mesh.index('dp'),
        process_count=1 if mesh is None else mesh.dp)
    if lead:
        print(f'{len(ds._records)} records, ~{ds.tokens_per_epoch} tokens/'
              f'epoch, {ds.steps_per_epoch()} steps/epoch/host', flush=True)

    def save(state):
        os.makedirs(args.save_dir, exist_ok=True)
        serving = os.path.join(args.save_dir, 'serving')
        training.save_train_state(state, args.save_dir, mesh)
        if lora:
            # the adapters alone as the JAX package's npz, and a merged
            # serving checkpoint (the base model itself stays as it is)
            if lead:
                lora_lib.save_lora(state.lora, os.path.join(
                    args.save_dir, 'adapters.npz'), alpha=args.lora_alpha)
            module = lora_lib.merge_lora(evo.model.module, state.lora,
                                         args.lora_alpha)
        else:
            training.load_masters(evo.model, state)
            module = evo.model.module
        if mesh is None:
            ckpt.save_native(module, serving, cfg=cfg)
            return
        from evo_tpu_torch.parallel.distributed import barrier
        from evo_tpu_torch.parallel.sharding import unshard
        if mesh.index('dp') == 0:
            full = unshard(module, mesh)
            if lead:
                ckpt.save_native(full, serving, cfg=cfg)
            del full
        barrier()

    start = done = state.step
    t0 = time.time()
    for ids, mask in ds.iter_batches():
        if done >= args.steps:
            break
        state, loss = step_fn(state, ids, mask)
        done += 1
        if lead and args.log_every and done % args.log_every == 0:
            loss = float(loss)          # sync point
            rate = (done - start) * args.batch_size * (args.seq_len + 1) \
                / max(time.time() - t0, 1e-9)
            print(f'step {done}  loss {loss:.4f}  '
                  f'{rate:,.0f} tok/s/host', flush=True)
        if args.save_every and done % args.save_every == 0:
            save(state)
    save(state)
    if lead:
        print(f'done: {done} steps; serving checkpoint at '
              f'{os.path.join(args.save_dir, "serving")}', flush=True)
    return state


if __name__ == '__main__':
    main()
