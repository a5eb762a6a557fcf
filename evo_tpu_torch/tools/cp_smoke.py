"""One rank of the context-parallel smoke run on the card.

    python -m evo_tpu_torch.tools.cp_smoke {model,small} <dir>

launched as two ranks with torchrun's environment (`parallel.distributed.
launch_local` does that). The ranks join over gloo, chosen explicitly, so
that both may share one card (NCCL refuses that), and make one cp = 2 mesh:
each rank holds the whole weights, its half of every sequence in the
residual stream, and half of the channels and heads inside the mixers and
in the caches. Writes what it saw to `<dir>/<part>_rank<r>.json`, tensors
beside it as `.pt`. `small` reads `<dir>/small_in.pt` (a small config and
ids) and writes the logits under each `cp_attn`, and under Ulysses at one
position fewer (a test's probe). `model`
reads `<dir>/cp_in.pt` (what the single process gave on the same inputs):

  (a) evo-1-8k-base (seed 0): one forward of the ids (B=1, L=2,048)
      under each `cp_attn` ('ulysses', 'ring', 'zigzag'), with launches,
      its time and
      the time spent in the cp collectives (each between device syncs);
      the logits against the single process's; then forwards of
      2,048 positions under the fused mixer and under the prefix kernel
      (kernels 6 and 7 at C/cp channels), against the Ulysses logits;
  (b) greedy generation from two 512-nt prompts, 16 tokens, under the bf16
      and the int8 KV cache: tokens, launches, the local cache's heads, and
      teacher forcing: the single process's tokens fed to the cp model,
      its logits at each step against the single process's; one decode
      step's time;
  (c) evo-1-131k-base (seed 0): a 10,240-nt sequence scored in segments of
      8,192, with launches, time and the time in the collectives.

Times are taken with both ranks on one card over gloo, whose all-to-alls
and sends pass through host memory: they say what this run took, nothing
of NCCL or of cp across cards.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

MODES = ('ulysses', 'ring', 'zigzag')


def _sync_time(fn, reps: int = 1):
    """Median wall ms of fn() between device syncs, and its last result."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2], out


@contextlib.contextmanager
def timed_collectives(spent: dict):
    """Each cp collective (the all-to-all, gathers, the ring's posts and
    waits, the float32 sums of `all_reduce_sum`, their host copies
    included) between device syncs. The ms go to spent['forward'], or to
    spent['backward'] inside autograd's backward (a remat recompute's
    included), and a train step's gradient sums over the mesh to
    spent['grad_sum']."""
    from evo_tpu_torch import lora, training
    from evo_tpu_torch.ops import ring_attention
    from evo_tpu_torch.parallel import collectives as c
    sites = ((c, 'exchange_blocks'), (c, 'gather_cpu'),
             (ring_attention, 'cp_exchange'), (c._Pending, 'wait'),
             (c, 'all_reduce_sum'))
    sums = ((training, 'all_reduce_sum'), (lora, 'sum_grads'))
    real = {(m, n): getattr(m, n) for m, n in sites + sums}
    depth = [0]                # a collective inside a timed one: not again

    def wrap(fn, key=None):
        def timed(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            where = key or ('forward' if torch._C._current_graph_task_id()
                            == -1 else 'backward')
            spent[where] = spent.get(where, 0.0) + 1e3 * (
                time.perf_counter() - t)
            return out
        return timed
    for (m, n), fn in real.items():
        setattr(m, n, wrap(fn, 'grad_sum' if (m, n) in sums else None))
    try:
        yield spent
    finally:
        for (m, n), fn in real.items():
            setattr(m, n, fn)


def _equal_across(t: torch.Tensor, mesh) -> bool:
    """Whether every cp rank holds bit-equal t (compared on the CPU)."""
    from evo_tpu_torch.parallel.collectives import gather_cpu
    parts = gather_cpu(t.detach().cpu().contiguous(), mesh, 'cp')
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got.float() - want.float()).abs()
    return dict(mean_abs=float(diff.mean()), max_abs=float(diff.max()),
                argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))


def part_forward(inp, evo, mesh, rank, d) -> dict:
    """(a): one forward a cp_attn, and the time in the collectives; the
    fused mixer and the prefix kernel over the first 2,048 positions."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.ops import _build
    module = evo.model.module
    ids = inp['ids'].cuda()
    ref = inp['logits'].cuda()
    model_lib.forward(module, ids)           # warm-up at full length
    out = {}
    for mode in MODES:
        cfg = evo.config.replace(cp_attn=mode)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with timed_collectives({}) as spent:
            ms, logits = _sync_time(
                lambda: model_lib.forward(module, ids, cfg))
        in_them = sum(spent.values())
        r = dict(ms=ms, launches=dict(_build.LAUNCHES),
                 collectives_ms=in_them, collectives_share=in_them / ms)
        r.update(_compare(logits, ref))
        r['equal_across_ranks'] = _equal_across(logits, mesh)
        if mode == 'ulysses':
            torch.save(logits.cpu(), os.path.join(d, f'cp_logits_rank{rank}'
                                                     '.pt'))
            head = logits[:, :2048]
        out[mode] = r
        del logits
    for key, flag in (('fused', 'hyena_fused_mixer'),
                      ('prefix', 'hyena_pallas_prefix')):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        logits = model_lib.forward(module, ids[:, :head.shape[1]],
                                   evo.config.replace(**{flag: True}))
        torch.cuda.synchronize()
        out[key] = dict(launches=dict(_build.LAUNCHES),
                        **_compare(logits, head))
    return out


def part_generate(inp, evo, mesh) -> dict:
    """(b): greedy generation under both caches, and teacher forcing with
    the single process's tokens."""
    from evo_tpu_torch.generation import Generator
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.scoring import prepare_batch
    tok = evo.tokenizer
    prompt_ids = prepare_batch(inp['prompts'], tok, prepend_bos=False)[0]
    prompt_ids = torch.as_tensor(prompt_ids, device='cuda').long()
    out = {}
    for label, kv in (('bf16', 'none'), ('int8', 'int8')):
        m = EvoModel(evo.config.replace(kv_quant=kv), evo.model.module)
        want = inp['generate'][label]
        n_new = want['tokens'].shape[1]
        gen = Generator(m, tok, top_k=1, temperature=0.0)
        gen.generate(input_ids=prompt_ids, num_tokens=2)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        toks, _, cache = gen.generate(input_ids=prompt_ids,
                                      num_tokens=n_new)
        torch.cuda.synchronize()
        r = dict(seconds=time.time() - t, launches=dict(_build.LAUNCHES),
                 tokens=toks.cpu().tolist())
        attn = next(x for x in cache['layers'] if isinstance(x, dict))
        r['cache_k_shape'] = list(attn['k'].shape)
        r['tokens_equal_across_ranks'] = _equal_across(toks, mesh)
        r['tokens_equal_single'] = float(
            (toks.cpu() == want['tokens']).float().mean())
        # teacher forcing: the single process's tokens, fed one a step
        forced = want['tokens'].cuda()
        cache = m.initialize_inference_params(
            prompt_ids.shape[0], prompt_ids.shape[1] + n_new)
        logits, cache = m.prefill(prompt_ids, cache)
        steps = [logits[:, -1]]
        for i in range(n_new - 1):
            logits, cache = m.decode_step(forced[:, i], cache)
            steps.append(logits)
        r['teacher'] = dict(_compare(torch.stack(steps, 1),
                                     want['steps'].cuda()),
                            yardstick=want['yardstick'])
        out[label] = r
        del cache
    # one decode step's time after the prompts (bf16 cache)
    cache = evo.model.initialize_inference_params(2, prompt_ids.shape[1]
                                                  + 16)
    logits, cache = evo.model(prompt_ids, inference_params_dict=cache)
    tok_t = logits[:, -1].argmax(-1)

    def step():
        nonlocal tok_t, cache
        o, cache = evo.model.decode_step(tok_t, cache)
        tok_t = o.argmax(-1)
    out['decode_step_ms'], _ = _sync_time(step, reps=9)
    return out


def part_long(inp, mesh) -> dict:
    """(c): the long sequence with evo-1-131k-base in segments of 8,192."""
    from evo_tpu_torch.models import Evo
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.scoring import score_sequences_segmented
    evo = Evo('evo-1-131k-base', 'cuda', random_init=True, seed=0,
              mesh=mesh)
    seq = inp['long_seq']

    def score():
        return score_sequences_segmented([seq], evo.model, evo.tokenizer,
                                         segment_len=8192)[0]
    _build.LAUNCHES.clear()
    with timed_collectives({}) as spent:
        ms, got = _sync_time(score)
    in_them = sum(spent.values())
    r = dict(seconds=ms / 1e3, launches=dict(_build.LAUNCHES), score=got,
             diff=abs(got - inp['long_score']), collectives_s=in_them / 1e3,
             collectives_share=in_them / ms)
    r['score_equal_across_ranks'] = _equal_across(torch.tensor([got]), mesh)
    return r


def part_small(d: str, mesh, rank: int) -> dict:
    """A small config's logits under each cp_attn, with launches."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.ops import _build
    inp = torch.load(os.path.join(d, 'small_in.pt'))
    cfg = tiny_config(**inp['config'])
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda', mesh)
    res = {}
    for mode in MODES:
        _build.LAUNCHES.clear()
        logits = model_lib.forward(module, inp['ids'].cuda(),
                                   cfg.replace(cp_attn=mode))
        torch.save(logits.cpu(), os.path.join(
            d, f'small_{mode}_rank{rank}.pt'))
        res[mode] = dict(_build.LAUNCHES)
    # a length cp does not divide, padded inside the model (Ulysses)
    logits = model_lib.forward(module, inp['ids'][:, :-1].cuda(), cfg)
    torch.save(logits.cpu(), os.path.join(d, f'small_ragged_rank{rank}.pt'))
    return res


def part_model(d: str, mesh, rank: int) -> dict:
    from evo_tpu_torch.models import Evo
    inp = torch.load(os.path.join(d, 'cp_in.pt'))
    t0 = time.time()
    res = {}
    evo = Evo('evo-1-8k-base', 'cuda', random_init=True, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    res['init_s'] = time.time() - t0
    res['weight_gib'] = torch.cuda.memory_allocated() / 2**30
    t = time.time()
    res['forward'] = part_forward(inp, evo, mesh, rank, d)
    res['forward_s'] = time.time() - t
    t = time.time()
    res['generate'] = part_generate(inp, evo, mesh)
    res['generate_s'] = time.time() - t
    res['peak_gib_8k'] = torch.cuda.max_memory_allocated() / 2**30
    del evo
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    res['long'] = part_long(inp, mesh)
    res['long_s'] = time.time() - t
    res['peak_gib_131k'] = torch.cuda.max_memory_allocated() / 2**30
    return res


def main(argv=None) -> int:
    part, d = (argv or sys.argv[1:])[:2]
    from evo_tpu_torch.parallel.distributed import initialize_distributed
    from evo_tpu_torch.parallel.mesh import make_mesh
    initialize_distributed(backend='gloo', device='cuda')
    mesh = make_mesh(dp=1, cp=2)
    rank = mesh.rank
    t = time.time()
    res = {'part': {'model': part_model, 'small': part_small}[part](
        d, mesh, rank)}
    res['seconds'] = time.time() - t
    with open(os.path.join(d, f'{part}_rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
