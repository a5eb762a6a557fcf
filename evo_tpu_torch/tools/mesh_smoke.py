"""One rank of the smoke runs of serving, speculative decoding and LoRA
under a mesh on the card.

    python -m evo_tpu_torch.tools.mesh_smoke {model,small} <dir>

launched as two ranks with torchrun's environment (`parallel.distributed.
launch_local` does that). The ranks join over gloo, chosen explicitly, so
that both may share one card (NCCL refuses that), and make one mesh a
part. Each writes what it saw to `<dir>/<part>_rank<r>.json` for the
caller to check against the single process.

`model` reads `<dir>/mesh_in.json` (the traffic, the speculation prompt,
the training corpus):

  (a) tp = 2, evo-1-8k-base at full width on its first 16 layers (seed
      0; 15 Hyena layers and the attention at 8): a
      `GenerationServer` on 4 slots over ragged requests (some sampled,
      one arriving after the second step), bf16 KV; then requests under
      the int8 KV cache. Tokens and log-probs of every request, the
      engine calls of the fills, decode chunks, launches, times, peak
      memory; one step() with every slot decoding in the profiler (host
      reads and copies outside the collectives, device-to-host copies),
      and one with each collective between device syncs (its share);
  (b) tp = 2 speculation on (a)'s model: `generate_speculative` at g = 8,
      32 new tokens, with `spec_agreement.OracleDrafter` (full and partial
      acceptance): tokens, log-probs, the engine calls by length,
      launches without the drafter's;
  (c) LoRA under tp = 2 on the first 9 layers at full width (seed 20, as
      chip_smoke.py phase 20): rank 8 on the seven default targets, 2
      steps at L = 2,049: losses, the loss after, launches, the base
      weights bit-unchanged, the adapters bit-equal across ranks;
  (d) dp = 2 and (e) cp = 2 serving of (a)'s bf16 traffic on the first 9
      layers (seed 0): each dp rank's rows of the slot batch, and under
      cp the offsets each decode step's attention took;
  (f) the requests that `cli.serve --tp 2` is given, through a tp = 2
      server with the CLI's settings over the same native checkpoint:
      the lines the CLI's rank 0 must write.

`small` reads `<dir>/small_in.pt` (a small bf16 config, prompts): a
tp = 2 server's greedy tokens (a test's probe).

Times are taken with both ranks on one card over gloo, whose collectives
pass through host memory: they say what this run took, nothing of NCCL or
of a mesh across cards.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import torch

# the first 9 layers of evo-1-8k-base: 8 Hyena layers and attention at 8
NINE = dict(num_layers=9, attn_layer_idxs=(8,), hyena_layer_idxs=())
# its first 16 layers, (a)'s and (b)'s depth: 15 Hyena layers and attention
# at 8 (the full 32 took ~115 s of collectives through the host)
SIXTEEN = dict(num_layers=16, attn_layer_idxs=(8,), hyena_layer_idxs=())
_COLLECTIVES = ('all_reduce', 'all_gather', 'all_to_all_single',
                'broadcast_object_list', 'batch_isend_irecv')


@contextlib.contextmanager
def _wrapped_collectives(wrap):
    """Each `torch.distributed` collective the port calls, through
    `wrap(fn)`."""
    import torch.distributed as dist
    real = {n: getattr(dist, n) for n in _COLLECTIVES}
    for n, fn in real.items():
        setattr(dist, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


class _Calls:
    """The engine facade with each call's length and route recorded: the
    launches of a fill or a verify pass follow from them."""

    def __init__(self, model):
        self._model, self.calls = model, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, ids, **kw):
        self.calls.append((int(ids.shape[-1]), bool(kw.get('resume'))))
        return self._model(ids, **kw)


def _gather_equal(values, mesh, axis) -> bool:
    """Whether every rank of `axis` holds bit-equal tensors."""
    from evo_tpu_torch.parallel.collectives import gather_cpu
    for t in values:
        parts = gather_cpu(t.detach().cpu().contiguous(), mesh, axis)
        if not all(torch.equal(parts[0], p) for p in parts[1:]):
            return False
    return True


def _profile_step(server) -> dict:
    """One step() with every slot decoding and nothing to fill, in the
    profiler, each collective (and the port's gathers and all-to-alls,
    their host copies included) in a 'collective' range: the host reads of
    CUDA tensors (`cpu`, `numpy`, `tolist`, `item`) and the scalar reads
    (`aten::_local_scalar_dense`) outside them, and every device-to-host
    copy on the device."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from evo_tpu_torch.parallel import collectives
    depth, reads = [0], []

    def wrap(fn):
        def ranged(*a, **k):
            depth[0] += 1
            try:
                with record_function('collective'):
                    return fn(*a, **k)
            finally:
                depth[0] -= 1
        return ranged

    def watch(name, fn):
        def read(t, *a, **k):
            if t.is_cuda and not depth[0]:
                reads.append(name)
            return fn(t, *a, **k)
        return read
    ports = [(collectives, n) for n in ('gather_cpu', 'all_to_all')]
    ports += [(torch.Tensor, n) for n in ('cpu', 'numpy', 'tolist', 'item')]
    real = [getattr(m, n) for m, n in ports]
    for (m, n), fn in zip(ports, real):
        setattr(m, n, wrap(fn) if m is collectives else watch(n, fn))
    torch.cuda.synchronize()
    try:
        with _wrapped_collectives(wrap):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                server.step()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t)
    finally:
        for (m, n), fn in zip(ports, real):
            setattr(m, n, fn)
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == 'collective' and e.device_type == cpu]

    def outside(e):
        return not any(s <= e.time_range.start <= t for s, t in spans)
    cuda = torch.autograd.DeviceType.CUDA
    return dict(
        wall_ms=wall_ms, collectives=len(spans), host_reads=reads,
        scalar_reads=sum(e.name == 'aten::_local_scalar_dense'
                         and outside(e) for e in events),
        device_to_host=sum(('DtoH' in e.name or 'Device -> P' in e.name)
                           for e in events if e.device_type == cuda))


def _timed_step(server) -> dict:
    """One step() with each collective between device syncs: its time and
    the collectives' share of it."""
    spent = [0.0]

    def wrap(fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[0] += 1e3 * (time.perf_counter() - t)
            return out
        return timed
    torch.cuda.synchronize()
    with _wrapped_collectives(wrap):
        t = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
    return dict(step_ms=ms, collectives_ms=spent[0],
                collectives_share=spent[0] / ms)


def serve(model, tok, requests, mesh, profile: bool = False) -> dict:
    """The traffic of `requests` (prompt, num_tokens, temperature, top_k,
    seed, late) through a server on 4 slots of 2,048 positions, decode
    chunks of 8 steps, prompts in chunks of 128, batched fills of 2; the
    lead submits (the late ones after its second step), the other ranks
    follow. With `profile`, then one step() of 4 decoding slots in the
    profiler and one with its collectives timed."""
    from evo_tpu_torch import serving
    from evo_tpu_torch.ops import _build
    chunks = []
    real_chunk = serving._decode_chunk

    def timed_chunk(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_chunk(*a, **k)
        torch.cuda.synchronize()
        chunks.append(1e3 * (time.perf_counter() - t))
        return out

    def new_server(m):
        return serving.GenerationServer(m, tok, max_slots=4, max_len=2048,
                                        steps_per_sync=8, prompt_chunk=128,
                                        prefill_batch=2)

    def submit(server, reqs):
        return [server.submit(prompt=r['prompt'], num_tokens=r['num_tokens'],
                              temperature=r['temperature'],
                              top_k=r['top_k'], seed=r['seed'])
                for r in reqs]

    warm = new_server(model)                 # cuBLAS's first calls
    if warm.lead:
        submit(warm, [dict(r, prompt=r['prompt'][:200], num_tokens=9)
                      for r in requests[:3]])
    warm.run()
    del warm
    spy = _Calls(model)
    server = new_server(spy)
    serving._decode_chunk = timed_chunk
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t = time.perf_counter()
        if server.lead:
            rids = submit(server, [r for r in requests if not r['late']])
            server.step()
            server.step()
            rids += submit(server, [r for r in requests if r['late']])
            results = server.run()
        else:
            results = server.run()
            rids = sorted(results)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        serving._decode_chunk = real_chunk
    order = ([i for i, r in enumerate(requests) if not r['late']]
             + [i for i, r in enumerate(requests) if r['late']])
    by_index = {i: results[rid] for i, rid in zip(order, rids)}
    res = dict(
        seconds=secs, launches=dict(_build.LAUNCHES), chunk_ms=chunks,
        calls=list(spy.calls),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        tokens=[by_index[i].token_ids.tolist() for i in range(len(requests))],
        logps=[by_index[i].logps.tolist() for i in range(len(requests))],
        rows=int(server._cache['offset'].shape[0]), base=server._base,
        new_tokens=sum(len(r.token_ids) for r in results.values()))
    res['tokens_per_s'] = res['new_tokens'] / secs
    if chunks:
        res['chunk_median_ms'] = statistics.median(chunks)
    if profile:
        # every slot decoding, nothing to fill: one step in the profiler,
        # one with its collectives timed
        if server.lead:
            submit(server, [dict(requests[-1], prompt=requests[-1]['prompt'][
                64 * i:64 * i + 64], num_tokens=25, temperature=0.0,
                late=False) for i in range(4)])
        server.step()
        res['profiled_step'] = _profile_step(server)
        res['timed_step'] = _timed_step(server)
        server.run()
    return res


def speculate(model, tok, inp) -> dict:
    """Greedy speculation at g = 8 with the oracle drafter."""
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.speculative import generate_speculative
    from evo_tpu_torch.tools.spec_agreement import OracleDrafter
    prompt, n, gamma = inp['spec_prompt'], 32, 8
    oracle = OracleDrafter(model, tok, len(prompt), inp['spec_schedule'])
    calls = _Calls(model)
    with oracle.installed():
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.perf_counter()
        toks, logps, stats = generate_speculative(calls, tok, prompt=prompt,
                                                  num_tokens=n, gamma=gamma)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t - oracle.seconds
    launches = dict(_build.LAUNCHES)
    for k, v in oracle.launches.items():
        launches[k] -= v
    return dict(seconds=secs, tokens=toks.tolist(), logps=list(logps),
                lengths=[c[0] for c in calls.calls],
                launches={k: v for k, v in launches.items() if v},
                accepted=stats.accepted, proposed=stats.proposed,
                cycles=stats.cycles, oracle_seconds=oracle.seconds)


def lora_steps(mesh, corpus) -> dict:
    """LoRA under tp = 2 on phase 20's 9 layers and batch."""
    from evo_tpu_torch import lora, training
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.io.dataset import PackedFastaDataset
    from evo_tpu_torch.models import config_for_model
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    cfg = config_for_model('evo-1-8k-base').replace(remat=True, **NINE)
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(20), 'cuda', mesh)
    ds = PackedFastaDataset([corpus], CharLevelTokenizer(512), seq_len=2048,
                            batch_size=1, seed=0)
    ids, mask = next(ds.iter_batches())
    adapters = lora.init_lora(torch.Generator(device='cuda').manual_seed(23),
                              module, rank=8)
    before = [p.clone() for p in module.parameters()]
    opt = training.make_optimizer(learning_rate=1e-3)
    state = lora.init_lora_train_state(adapters, opt)
    step = lora.make_lora_train_step(module, opt, alpha=16.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = step(state, ids, mask)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t)
    res = dict(losses=losses, step_s=secs, launches=dict(_build.LAUNCHES),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    lora.attach_lora(module, state.lora, 16.0)
    with torch.no_grad():
        res['loss_after'] = float(training.next_token_loss(
            module, None, ids, mask))
    lora.detach_lora(module)
    res['base_unchanged'] = all(torch.equal(a, b) for a, b in zip(
        before, module.parameters()))
    res['adapters_equal_across_ranks'] = _gather_equal(
        lora.named_adapters(state.lora).values(), mesh, 'tp')
    return res


def _offsets_seen():
    """Record, for each decode step's attention call, whether its offset
    was a (B,) device tensor and whether the layer had an active cp
    axis."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.parallel.mesh import has_cp
    seen, real = [], model_lib.mha_step

    def spy(p, cfg, x_t, kv, offset):
        seen.append((isinstance(offset, torch.Tensor)
                     and offset.device.type == 'cuda'
                     and tuple(offset.shape) == (x_t.shape[0],),
                     has_cp(p.mesh)))
        return real(p, cfg, x_t, kv, offset)
    model_lib.mha_step = spy
    return seen, lambda: setattr(model_lib, 'mha_step', real)


def cli_reference(cli, mesh) -> dict:
    """(f): the CLI's requests through `GenerationServer` with the settings
    its flags (`cli['flags']`) give, on `mesh`: each request's tokens,
    log-probs, score and sequence."""
    from evo_tpu_torch.cli import serve as serve_cli
    from evo_tpu_torch.models import Evo
    from evo_tpu_torch.serving import GenerationServer
    evo = Evo('evo-1-8k-base', 'cuda', checkpoint_path=cli['path'],
              mesh=mesh)
    server = GenerationServer(evo.model, evo.tokenizer,
                              **serve_cli.server_settings(
                                  serve_cli.build_parser().parse_args(
                                      cli['flags'])))
    if server.lead:
        rids = [server.submit(prompt=p, num_tokens=cli['num_tokens'])
                for p in cli['prompts']]
        results = server.run()
    else:
        results = server.run()
        rids = sorted(results)
    return dict(tokens=[results[r].token_ids.tolist() for r in rids],
                logps=[results[r].logps.tolist() for r in rids],
                scores=[results[r].score for r in rids],
                sequences=[results[r].sequence for r in rids])


def part_model(d: str, rank: int) -> dict:
    from evo_tpu_torch.models import Evo, EvoModel
    from evo_tpu_torch.parallel.mesh import make_mesh
    with open(os.path.join(d, 'mesh_in.json')) as f:
        inp = json.load(f)
    res = {}
    # (a) and (b): tp = 2 on the first 16 layers
    tp = make_mesh(dp=1, tp=2)
    t = time.perf_counter()
    evo = Evo('evo-1-8k-base', 'cuda', random_init=True, seed=0, mesh=tp,
              config_overrides=SIXTEEN)
    torch.cuda.synchronize()
    res['init_s'] = time.perf_counter() - t
    res['weight_gib'] = torch.cuda.memory_allocated() / 2**30
    tok = evo.tokenizer
    t = time.perf_counter()
    res['a'] = serve(evo.model, tok, inp['requests'], tp, profile=True)
    res['a_int8'] = serve(EvoModel(evo.config.replace(kv_quant='int8'),
                                   evo.model.module), tok,
                          inp['requests_int8'], tp)
    res['a_s'] = time.perf_counter() - t
    t = time.perf_counter()
    res['b'] = speculate(evo.model, tok, inp)
    res['b_s'] = time.perf_counter() - t
    del evo
    torch.cuda.empty_cache()
    # (c) LoRA under tp = 2
    t = time.perf_counter()
    res['c'] = lora_steps(tp, inp['corpus'])
    res['c_s'] = time.perf_counter() - t
    torch.cuda.empty_cache()
    # (d) dp = 2 and (e) cp = 2 serving on 9 layers
    for part, mesh in (('d', make_mesh(dp=2, tp=1)),
                       ('e', make_mesh(dp=1, cp=2, tp=1))):
        t = time.perf_counter()
        evo = Evo('evo-1-8k-base', 'cuda', random_init=True, seed=0,
                  mesh=mesh, config_overrides=NINE)
        seen, restore = _offsets_seen()
        try:
            res[part] = serve(evo.model, tok, inp['requests'], mesh)
        finally:
            restore()
        res[part]['device_offsets'] = all(s[0] for s in seen)
        res[part]['cp_steps'] = sum(s[1] for s in seen)
        res[part]['steps_seen'] = len(seen)
        res[f'{part}_s'] = time.perf_counter() - t
        del evo
        torch.cuda.empty_cache()
    t = time.perf_counter()
    res['f'] = cli_reference(inp['cli'], tp)
    res['f_s'] = time.perf_counter() - t
    return res


def part_small(d: str, rank: int) -> dict:
    """A small bf16 config's greedy tokens through a tp = 2 server."""
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import tiny_config
    from evo_tpu_torch.models import EvoModel
    from evo_tpu_torch.ops import _build
    from evo_tpu_torch.parallel.mesh import make_mesh
    from evo_tpu_torch.serving import serve_requests
    from evo_tpu_torch.tokenizer import CharLevelTokenizer
    inp = torch.load(os.path.join(d, 'small_in.pt'))
    cfg = tiny_config(**inp['config'])
    mesh = make_mesh(dp=1, tp=2)
    module = model_lib.random_init(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda', mesh)
    _build.LAUNCHES.clear()
    results = serve_requests(EvoModel(cfg, module), CharLevelTokenizer(512),
                             inp['prompts'], num_tokens=inp['num_tokens'],
                             max_slots=2, steps_per_sync=4)
    return dict(tokens=[r.token_ids.tolist() for r in results],
                launches=dict(_build.LAUNCHES))


def main(argv=None) -> int:
    part, d = (argv or sys.argv[1:])[:2]
    from evo_tpu_torch.parallel.distributed import (get_rank,
                                                    initialize_distributed)
    initialize_distributed(backend='gloo', device='cuda')
    rank = get_rank()
    t = time.time()
    res = {'part': {'model': part_model, 'small': part_small}[part](d, rank)}
    res['seconds'] = time.time() - t
    with open(os.path.join(d, f'{part}_rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
