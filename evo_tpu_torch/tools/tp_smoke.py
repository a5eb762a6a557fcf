"""One rank of the tensor-parallel smoke runs on the card.

    python -m evo_tpu_torch.tools.tp_smoke {model,train,small}[+...] <dir>

launched as two ranks with torchrun's environment (`parallel.distributed.
launch_local` does that). The ranks join over gloo, chosen explicitly, so
that both may share one card (NCCL refuses that); each holds its
tensor-parallel half (tp = 2) of the model and runs the port's entry
points, and writes what it saw to `<dir>/<part>_rank<r>.json` (tensors
beside it as `.pt`) for the caller to check. Parts joined by '+' run in
that order in one launch. What each part reads:

  model  `<dir>/model_in.pt`: evo-1-8k-base (seed 0) at full width on
         its first 9 layers (8 Hyena layers, the attention at 8): one
         forward of the ids (B=1, L=2,048) against the single-process
         logits of those layers and their one-rounding yardstick; greedy
         generation under the bf16 and the int8 KV cache with teacher
         forcing; forwards of 2,048 positions under the fused mixer and
         under the prefix kernel; scores of ragged sequences with bf16
         and int8 weights; launches, times, peak memory, and a second
         forward with each tp reduce between device syncs for the time
         spent in them;
  train  `<dir>/train_in.json`: full fine-tuning of the first 9 layers
         (seed 20) at L = 2,049, 2 sharded train steps;
  small  `<dir>/small_in.pt`: a small config's logits (a test's probe).

Times are taken with both ranks on one card over gloo, whose reduces pass
through host memory: they say what this run took, nothing of NCCL or of
tensor parallelism across cards.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

# the first 9 layers of evo-1-8k-base, the model part's depth: 8 Hyena
# layers and the attention at 8 (the full 32 took ~120 s of reduces
# through the host)
NINE = dict(num_layers=9, attn_layer_idxs=(8,), hyena_layer_idxs=())


def _sync_time(fn, reps: int = 3):
    """Median wall ms of fn() between device syncs, and its last result."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2], out


def _nudged(model, sign):
    """The forward with one extra bf16 rounding step (a relative 2^-8 of
    random sign) on the output of layer 0's first norm: the yardstick of
    chip_smoke.py's phase 5."""
    def forward(tokens):
        hook = model.module.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype))
        try:
            return model(tokens)[0]
        finally:
            hook.remove()
    return forward


def _gather_equal(t: torch.Tensor, mesh) -> bool:
    """Whether every tp rank holds bit-equal t (compared on the CPU)."""
    from evo_tpu_torch.parallel.collectives import gather_cpu
    parts = gather_cpu(t.detach().cpu().contiguous(), mesh, 'tp')
    return all(torch.equal(parts[0], p) for p in parts[1:])


def part_model(d: str, mesh, rank: int) -> dict:
    import numpy as np

    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import Evo, EvoModel
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.parallel import collectives
    from evo_tpu_torch.scoring import prepare_batch, score_sequences

    inp = torch.load(os.path.join(d, 'model_in.pt'))
    res = {}
    t0 = time.time()
    evo = Evo('evo-1-8k-base', 'cuda', random_init=True, seed=0, mesh=mesh,
              config_overrides=NINE)
    torch.cuda.synchronize()
    res['init_s'] = time.time() - t0
    res['weight_gib'] = torch.cuda.memory_allocated() / 2**30
    model, tok = evo.model, evo.tokenizer
    ids = inp['ids'].cuda()

    # one forward: launches, time, and logits against the single process;
    # the warm-up is at full length, so that neither timed forward is the
    # first at this length
    model(ids)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    res['forward_ms'], (logits, _) = _sync_time(lambda: model(ids), reps=1)
    res['launches_forward'] = dict(_build.LAUNCHES)
    # the same forward again, each reduce between device syncs: the time
    # spent in the reduces, and the instrumented forward's own time
    spent = [0.0]
    real = collectives.all_reduce_sum

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out
    collectives.all_reduce_sum = timed
    try:
        res['forward_instrumented_ms'], _ = _sync_time(lambda: model(ids),
                                                       reps=1)
    finally:
        collectives.all_reduce_sum = real
    res['reduce_ms'] = 1e3 * spent[0]
    res['reduce_share'] = res['reduce_ms'] / res['forward_instrumented_ms']
    torch.save(logits.cpu(), os.path.join(d, f'logits_rank{rank}.pt'))
    ref = inp['logits9'].cuda()
    diff = (logits - ref).abs()
    res['forward_mean_abs'] = float(diff.mean())
    res['forward_max_abs'] = float(diff.max())
    res['forward_argmax_agree'] = float(
        (logits.argmax(-1) == ref.argmax(-1)).float().mean())
    del ref, diff

    # greedy generation from two 512-nt prompts, bf16 and int8 KV: the
    # tokens, launches, and teacher forcing against one forward
    sign = torch.randint(0, 2, (1, 1, evo.config.hidden_size), device='cuda',
                         generator=torch.Generator('cuda').manual_seed(5))
    prompt_ids = prepare_batch(inp['prompts'], tok, prepend_bos=False)[0]
    P, n_new = prompt_ids.shape[1], 16
    for label, m in (('bf16', model),
                     ('int8', EvoModel(evo.config.replace(kv_quant='int8'),
                                       model.module))):
        gen = Generator(m, tok, top_k=1, temperature=0.0)
        gen.generate(input_ids=prompt_ids, num_tokens=2)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        toks, steps, _ = gen.generate(input_ids=prompt_ids,
                                      num_tokens=n_new)
        torch.cuda.synchronize()
        res[f'generate_{label}_s'] = time.time() - t
        res[f'launches_generate_{label}'] = dict(_build.LAUNCHES)
        res[f'tokens_{label}'] = toks.cpu().tolist()
        full = torch.cat([torch.as_tensor(prompt_ids, device='cuda').long(),
                          toks], dim=1)
        want = m(full)[0][:, P - 1:P - 1 + n_new]
        floor = (_nudged(m, sign)(full)[:, P - 1:P - 1 + n_new]
                 - want).abs()
        diff = (steps - want).abs()
        res[f'teacher_{label}'] = dict(
            mean_abs=float(diff.mean()), max_abs=float(diff.max()),
            yardstick=float(floor.mean()), argmax_agree=float(
                (steps.argmax(-1) == want.argmax(-1)).float().mean()))
    # one decode step's time after the 512-nt prompts (bf16 cache)
    cache = model.initialize_inference_params(2, P + 16)
    logits_p, cache = model(prompt_ids, inference_params_dict=cache)
    tok_t = logits_p[:, -1].argmax(-1)

    def step():
        nonlocal tok_t, cache
        out, cache = model.decode_step(tok_t, cache)
        tok_t = out.argmax(-1)
    res['decode_step_ms'], _ = _sync_time(step, reps=9)
    del cache, logits_p

    # the fused mixer (kernel 6 at C/tp channels) over the first 2,048
    # positions: launches, and the logits against the unfused tp
    # forward's first 2,048 (a causal model's), within the yardstick
    n = 2048
    _build.LAUNCHES.clear()
    flog = model_lib.forward(model.module, ids[:, :n], evo.config.replace(
        hyena_fused_mixer=True))
    torch.cuda.synchronize()
    res['launches_fused_forward'] = dict(_build.LAUNCHES)
    res['fused_mean_abs'] = float((flog - logits[:, :n]).abs().mean())
    del flog
    # the prefix kernel (kernel 7 at C/tp channels) in the unfused long
    # conv over the same 2,048 positions: launches, and the logits
    _build.LAUNCHES.clear()
    plog = model_lib.forward(model.module, ids[:, :n], evo.config.replace(
        hyena_pallas_prefix=True))
    torch.cuda.synchronize()
    res['launches_prefix_forward'] = dict(_build.LAUNCHES)
    res['prefix_mean_abs'] = float((plog - logits[:, :n]).abs().mean())
    del plog
    res['logits_equal_across_ranks'] = _gather_equal(logits, mesh)
    res['tokens_equal_across_ranks'] = all(
        _gather_equal(torch.tensor(res[f'tokens_{k}']), mesh)
        for k in ('bf16', 'int8'))
    del logits

    # scores of ragged sequences, bf16 and int8 weights
    res['scores_bf16'] = score_sequences(inp['seqs'], model, tok)
    res['peak_gib_bf16'] = torch.cuda.max_memory_allocated() / 2**30
    del evo, model
    torch.cuda.empty_cache()
    evo8 = Evo('evo-1-8k-base', 'cuda', random_init=True, seed=0, mesh=mesh,
               config_overrides=dict(NINE, weight_quant='int8'))
    res['scores_int8'] = score_sequences(inp['seqs'], evo8.model,
                                         evo8.tokenizer)
    res['all_finite'] = bool(np.all(np.isfinite(res['scores_bf16'] +
                                                res['scores_int8'])))
    res['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    return res


def part_train(d: str, mesh, rank: int) -> dict:
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch import training
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.models import config_for_model
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.parallel.sharding import tp_axis
    from evo_tpu_torch.tokenizer import CharLevelTokenizer

    with open(os.path.join(d, 'train_in.json')) as f:
        inp = json.load(f)
    cfg = config_for_model('evo-1-8k-base').replace(
        num_layers=9, attn_layer_idxs=(8,), hyena_layer_idxs=(), remat=True)
    torch.cuda.reset_peak_memory_stats()
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(20), 'cuda', mesh)
    ds = PackedFastaDataset([inp['corpus']], CharLevelTokenizer(512),
                            seq_len=2048, batch_size=1, seed=0)
    ids, mask = next(ds.iter_batches())
    opt = training.make_optimizer(learning_rate=1e-4)
    state = training.init_train_state(module, opt)
    step = training.make_sharded_train_step(module, opt, mesh)
    replicated = [n for n in state.params if tp_axis(n) is None]
    _build.LAUNCHES.clear()
    losses, secs, equal = [], [], []
    for _ in range(2):
        t = time.time()
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
        secs.append(time.time() - t)
        equal.append(all(_gather_equal(state.params[n], mesh)
                         for n in replicated))
    res = dict(losses=losses, step_s=secs, replicated_equal=equal,
               launches=dict(_build.LAUNCHES),
               n_replicated=len(replicated))
    with torch.no_grad():
        res['loss_after'] = float(training.next_token_loss(
            module, None, ids, mask))
    res['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    return res


def part_small(d: str, mesh, rank: int) -> dict:
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.ops import _build

    inp = torch.load(os.path.join(d, 'small_in.pt'))
    cfg = tiny_config(**inp['config'])
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda', mesh)
    _build.LAUNCHES.clear()
    logits = EvoModel(cfg, module)(inp['ids'].cuda())[0]
    torch.save(logits.cpu(), os.path.join(d, f'small_logits_rank{rank}.pt'))
    return dict(launches=dict(_build.LAUNCHES))


def main(argv=None) -> int:
    part, d = (argv or sys.argv[1:])[:2]
    from evo_tpu_torch.parallel.distributed import initialize_distributed
    from evo_tpu_torch.parallel.mesh import make_mesh
    initialize_distributed(backend='gloo', device='cuda')
    mesh = make_mesh(dp=1, tp=2)
    rank = mesh.rank
    for name in part.split('+'):
        t = time.time()
        res = {'part': {'model': part_model, 'train': part_train,
                        'small': part_small}[name](d, mesh, rank)}
        res['seconds'] = time.time() - t
        with open(os.path.join(d, f'{name}_rank{rank}.json'), 'w') as f:
            json.dump(res, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
