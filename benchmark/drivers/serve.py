"""Generation through `serving.GenerationServer` under a closed loop of
design clients: each client sends a group of requests of one prompt
(`generator.DesignTraffic`) and sends its next group when all of them
have finished. Set-up submits every client's first group and steps until
every slot holds a request; the window then calls `step()` until the time
is up. A delivery is the new tokens a `step()` hands one request; its gap
is the time since that request's previous delivery (or its submission)
over the tokens it carried."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator, roofline
from benchmark.harness import log
from benchmark.reference import striped_hyena
from evo_tpu_torch.serving import GenerationServer


class Request:
    def __init__(self, client, prompt, num_tokens, temperature, t):
        self.rid, self.client = None, client
        self.ids = np.frombuffer(prompt.encode(), dtype=np.uint8).astype(
            np.int32)
        self.num_tokens, self.temperature = num_tokens, temperature
        self.t_last, self.seen = t, 0
        self.result = None


class State:
    def __init__(self, model, mix, seed):
        self.mix = mix
        self.srv = GenerationServer(
            model, None, max_slots=mix['max_slots'], max_len=mix['max_len'],
            top_k=mix['top_k'], steps_per_sync=mix['steps_per_sync'],
            prompt_chunk=mix['prompt_chunk'],
            prefill_chunks_per_sync=mix['prefill_chunks_per_sync'],
            prefill_batch=mix['prefill_batch'],
            seed=seed & generator.SEED_MASK)
        self.traffic = generator.DesignTraffic(seed, mix)
        self.live = {}            # rid -> Request, not yet finished
        self.by_client = {}       # client -> its group's Requests
        self.finished = []


def _submit(st: State, client: int) -> None:
    g = st.traffic.next_group()
    now = time.perf_counter()
    reqs = []
    for temp in g['temperatures']:
        req = Request(client, g['prompt'], g['num_tokens'], temp, now)
        req.rid = st.srv.submit(input_ids=req.ids, num_tokens=req.num_tokens,
                                temperature=temp)
        st.live[req.rid] = req
        reqs.append(req)
    st.by_client[client] = reqs


def _step(st: State, out: dict) -> None:
    """One `step()`, its deliveries, and the clients' next groups. Every
    request that received tokens held a slot through the step's decode
    chunk; `out['live']` keeps its (prompt length, tokens before, tokens
    after) for the traced window's bounds."""
    st.srv.step()
    now = time.perf_counter()
    done_clients, live = set(), []
    for rid, req in list(st.live.items()):
        n = st.srv.progress(rid)
        d = n - req.seen
        if d > 0:
            P = len(req.ids)
            out['served'].add(rid)
            out['gaps'].append(1e3 * (now - req.t_last) / d)
            out['tokens'] += d
            live.append((P, req.seen, n))
            if req.seen == 0:               # filled and admitted
                out['flops'] += roofline.sequence_flops(out['cfg'], P)
                out['admitted'].append(P)
            # token k >= 1 comes from the decode step at position P + k - 1
            first = max(req.seen, 1)
            if n > first:
                out['decode_tokens'] += n - first
                out['flops'] += roofline.sequence_flops(
                    out['cfg'], n - first, start=P + first - 1)
            req.t_last, req.seen = now, n
        res = st.srv.result(rid)
        if res is not None:
            req.result = res
            st.finished.append(req)
            del st.live[rid]
            if all(r.result is not None for r in st.by_client[req.client]):
                done_clients.add(req.client)
    out['live'].append(live)
    for c in sorted(done_clients):
        _submit(st, c)
    out['steps'] += 1


def _new_out(ctx) -> dict:
    return dict(cfg=ctx.model_cfg, gaps=[], tokens=0, decode_tokens=0,
                flops=0, steps=0, admitted=[], live=[], served=set())


def setup(ctx, model):
    mix = ctx.cell.traffic
    st = State(model, mix, ctx.seed)
    for c in range(mix['clients']):
        _submit(st, c)
    out = _new_out(ctx)
    with torch.no_grad():
        # every fill of the first wave, then one step of a full batch
        for _ in range(mix['setup_steps']):
            _step(st, out)
            if sum(r.seen > 0 for r in st.live.values()) >= mix['max_slots']:
                break
        _step(st, out)
    return st


def window(ctx, st: State, seconds: float) -> dict:
    out = _new_out(ctx)
    t0 = time.perf_counter()
    ends = []
    with torch.no_grad():
        while time.perf_counter() - t0 < seconds:
            _step(st, out)
            ends.append(time.perf_counter())
    ctx.sync()
    elapsed = time.perf_counter() - t0
    steps_ms = np.diff([t0] + ends) * 1e3
    log(f'window: {len(ends)} steps, ms a step min / median / max '
        f'{steps_ms.min():.1f} / {np.median(steps_ms):.1f} / '
        f'{steps_ms.max():.1f}')
    mix = st.mix
    return dict(window_s=elapsed, steps=out['steps'],
                decode_steps=out['steps'] * mix['steps_per_sync'],
                slots=mix['max_slots'], tokens=out['tokens'],
                decode_tokens=out['decode_tokens'], gaps_ms=out['gaps'],
                model_flops=out['flops'], attempted=len(out['served']),
                failed=int(sum(not np.all(np.isfinite(r.result.logps))
                               for r in st.finished
                               if r.rid in out['served'])))


def traced(ctx, st: State) -> dict:
    out = _new_out(ctx)
    with torch.no_grad():
        for _ in range(st.mix['traced_steps']):
            _step(st, out)
    return dict(steps=out['steps'],
                decode_steps=out['steps'] * st.mix['steps_per_sync'],
                slots=st.mix['max_slots'],
                steps_per_sync=st.mix['steps_per_sync'],
                live=out['live'],
                admitted_prompts=out['admitted'])


def release(st: State) -> dict:
    kept = [r for r in st.finished if not r.result.cancelled]
    st.srv = None
    return dict(finished=kept)


def _pick(ctx, reqs, k: int):
    if not reqs:
        return []
    longest = max(range(len(reqs)), key=lambda i: reqs[i].num_tokens)
    idx = generator.stratified_pick(generator.rng(ctx.seed, 6), len(reqs),
                                    k, must=[longest])
    return [reqs[i] for i in idx]


def check(ctx, kept: dict, sd) -> list:
    """Teacher forcing over prompt + served tokens: the widest gap by
    which a greedy request's served token's log-probability lies below
    the reference's best at that position, and the widest gap between
    the log-probability the server recorded for a served token and the
    reference's."""
    if sd is None:
        return []
    lim = ctx.cell.limits
    fin = kept['finished']
    greedy = [r for r in fin if r.temperature <= 0]
    sampled = [r for r in fin if r.temperature > 0]
    chosen = (_pick(ctx, greedy, lim['greedy_requests'])
              + _pick(ctx, sampled, lim['sampled_requests']))
    dev = next(iter(sd.values())).device
    greedy_gap, logp_gap, gaps = 0.0, 0.0, []
    for r in chosen:
        toks = np.asarray(r.result.token_ids, dtype=np.int64)
        ids = torch.from_numpy(np.concatenate([r.ids, toks])).to(dev)
        P = len(r.ids)
        lp = torch.log_softmax(striped_hyena.logits(
            sd, ctx.model_cfg, ids[:-1])[P - 1:], dim=-1)
        tok = ids[P:, None]
        want = lp.gather(-1, tok)[:, 0]
        got = torch.as_tensor(r.result.logps, device=dev).float()
        gap = (got - want).abs()
        gaps.append(gap)
        logp_gap = max(logp_gap, float(gap.max()))
        if r.temperature <= 0:
            greedy_gap = max(greedy_gap,
                             float((lp.max(-1).values - want).max()))
    # a run that finished no greedy or no sampled request has compared
    # nothing of that kind: not correct
    uncompared = float(not greedy or not sampled)
    found = dict(greedy_gap=greedy_gap, logp_gap=logp_gap,
                 logp_mean_gap=float(torch.cat(gaps).mean()) if gaps else 0.0)
    return [(k, v, lim[k]) for k, v in found.items() if k in lim] + [
        ('uncompared', uncompared, 0.0)]
