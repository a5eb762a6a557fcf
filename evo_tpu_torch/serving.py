"""Continuous-batching generation server (port of `evo_tpu/serving.py`).

Every request owns one row ("slot") of a shared decode cache of
`max_slots` rows, and a queued request is prefilled into a slot as soon as
one frees up, so ragged, staggered traffic decodes as one batch:

    submit -> fill (B=1, or a batched prefill, in prompt chunks)
           -> admit into a slot -> decode chunk (`steps_per_sync` steps of
           the whole slot batch) -> harvest -> results

  * **Static shapes.** One (max_slots, cache_len) decode cache. The
    raggedness lives in an int32 (max_slots,) offset tensor on the device:
    `model.decode_step` takes per-row offsets (per-row rotary positions,
    KV writes and attention masks; `layers/attention.py`), and kernels 4
    and 5 read them from the device. No shape depends on the request mix.
  * **Admission copies on the device.** A request is prefilled into a
    scratch cache of its own row count; admission samples its first token
    with the request's generator and copies the row into the slot in
    place (`_admit_slot`). Nothing of the cache goes through the host, and
    the first token's readback waits for the next harvest
    (`_flush_firsts`).
  * **Decode runs in chunks of `steps_per_sync` steps** with no host read
    inside: tokens and log-probs go into preallocated (steps, B) device
    tensors that the host reads once after the chunk. Slots that finish
    mid-chunk discard at most `steps_per_sync - 1` tokens.
  * **Per-slot sampling.** Temperature, top-k and top-p are (B,) tensors
    (temperature <= 0 is greedy, by `torch.where`), and each sampled slot
    draws from a `torch.Generator` of its own, seeded on admission from
    (server seed, request seed): a request's samples do not depend on its
    co-tenants, its arrival or its slot. The streams are not the JAX
    package's threefry streams.

Rows without a live request keep stepping; their outputs are discarded and
their cache row is overwritten in full at the next admission. The host
bounds every request by `max_len` and keeps every slot's offset inside the
cache (rows that run past their request's end are held at its last
position), so the per-row KV writes need no bound check on the device.
With device offsets the kernels cannot trim the key range on the host:
kernel 5 sizes its split over the whole cache, and kernel 4 takes, for
each row, the key tiles up to that row's offset.

Under a mesh (`parallel/`, one process a card) every rank builds the same
server over its `EvoModel` and runs the same schedule:

  * **Intake on the first rank.** Only rank 0 takes `submit` and
    `cancel` (and is the `lead`); at the start of each `step()` it
    broadcasts what it took since the last one, and the other ranks apply
    it in the same order, so every host holds the same queue, slots and
    results. `run()` on the lead ends with an 'end' message that ends the
    others' `run()`; `stop()` sends 'stop', which ends their `follow()`
    (the HTTP server's followers). An idle `ServerLoop` sends an empty
    step every `HEARTBEAT` seconds, so that no follower waits in a
    broadcast past the process group's timeout.
  * **tp and cp.** Each rank holds its heads and channels of every cache
    (`parallel.sharding.cache_shardings`) and runs every fill, decode
    step and sample on them; the logits are whole on every rank and the
    slot generators are seeded alike, so the ranks draw the same tokens.
  * **dp.** A dp rank holds its contiguous block of `dp_rows(max_slots)`
    slots (the last block padded with rows no request gets) and decodes
    and samples only those; the chunk's tokens and log-probs are gathered
    over dp in its one readback (`collectives.gather_rows_to_host`).
    Fills run unsplit on every dp replica (a B=1 fill cannot split
    anyway): every replica samples each admitted request's first token
    from the same logits with the request's own generator, and the
    slot's owner copies the row into its block and keeps the generator.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from evo_tpu_torch import model as model_lib
from evo_tpu_torch.generation import _cache_kv_len
from evo_tpu_torch.ops.sampling import NEG_INF
from evo_tpu_torch.parallel.collectives import (broadcast_object, dp_rows,
                                                gather_rows_to_host)

_MASK64 = (1 << 64) - 1
# seconds between the empty steps an idle ServerLoop sends its followers
HEARTBEAT = 10.0


def _stream_seed(server_seed: int, request_seed: int) -> int:
    """The seed of a request's generator: a splitmix64 mix of the server's
    and the request's seeds, on the host, 63 bits."""
    x = ((server_seed & _MASK64) * 0x9E3779B97F4A7C15
         + (request_seed & _MASK64)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def _filter_slots(scaled: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row top-k, then top-p, over temperature-scaled logits (B, V),
    with the tie-inclusive thresholds of `ops/sampling.py`: k <= 0 or
    k >= V keeps every token, p >= 1 keeps every token, the top token is
    always kept. Filtered logits become NEG_INF. A pure tensor function of
    the (B,) parameters: no host branch on their values."""
    V = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = srt.gather(-1, (top_ks.clamp(1, V).long() - 1)[:, None])
    keep_k = ((top_ks <= 0) | (top_ks >= V))[:, None] | (scaled >= kth)
    filt = torch.where(keep_k, scaled, NEG_INF)
    # the nucleus after top-k: the smallest logit of the shortest sorted
    # prefix of the filtered distribution whose probability reaches p
    srt_f = torch.sort(filt, dim=-1, descending=True).values
    probs = torch.softmax(srt_f, dim=-1)
    # the top token is kept by an operation, not by an item assignment,
    # which would read a host scalar through `aten::_local_scalar_dense`
    keep_sorted = (((torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None])
                   | (torch.arange(V, device=scaled.device) == 0))
    pth = torch.where(keep_sorted, srt_f, float('inf')).amin(
        dim=-1, keepdim=True)
    keep_p = (top_ps >= 1.0)[:, None] | (filt >= pth)
    return torch.where(keep_p, filt, NEG_INF)


def _sample_slots(logits: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor, temps: torch.Tensor,
                  generators: Sequence[Optional[torch.Generator]]):
    """Per-slot sampling. logits (B, V); top_ks (B,) int, top_ps and temps
    (B,) float32; generators: one per row, None for a row that draws
    nothing (greedy or idle).

    Rows with temps <= 0 take the argmax; the others sample the filtered
    temperature-scaled distribution by an exponential race (the argmax of
    p / E with E ~ Exp(1) from the row's own generator, one draw per
    token). Returns (tokens (B,) int64, logp (B,) float32), logp being the
    chosen token's log-probability under the UNFILTERED distribution."""
    logits32 = logits.float()
    logp_full = torch.log_softmax(logits32, dim=-1)
    greedy = logits32.argmax(dim=-1)
    filt = _filter_slots(logits32 / temps.clamp(min=1e-6)[:, None], top_ks,
                         top_ps)
    probs = torch.softmax(filt, dim=-1)
    noise = torch.ones_like(probs)
    for b, gen in enumerate(generators):
        if gen is not None:
            noise[b].exponential_(generator=gen)
    sampled = (probs / noise.clamp(min=1e-30)).argmax(dim=-1)
    tok = torch.where(temps <= 0.0, greedy, sampled)
    return tok, logp_full.gather(-1, tok[:, None])[:, 0]


def _decode_chunk(module, tokens: torch.Tensor, cache, top_ks, top_ps,
                  temps, generators, steps: int):
    """`steps` decode + sample steps of the whole slot batch. tokens (B,)
    int64: each slot's current token. Returns (next tokens, cache, emitted
    (steps, B) int64, logps (steps, B) float32), all on the device.

    Nothing here reads the device: the offsets advance on the device, and
    a row that passes the cache's last position (a request that ended
    mid-chunk) is held there, where its writes touch only its own row."""
    B = tokens.shape[0]
    emitted = torch.empty((steps, B), dtype=torch.int64,
                          device=tokens.device)
    logps = torch.empty((steps, B), dtype=torch.float32,
                        device=tokens.device)
    T = _cache_kv_len(cache)
    for i in range(steps):
        logits, cache = model_lib.decode_step(module, tokens, cache)
        if T is not None:
            cache['offset'].clamp_(max=T - 1)
        tokens, logp = _sample_slots(logits, top_ks, top_ps, temps,
                                     generators)
        emitted[i] = tokens
        logps[i] = logp
    return tokens, cache, emitted, logps


def _admit_slot(batch_cache, fill_cache, src: int, slot: int) -> None:
    """Copy row `src` of a filled prefill cache into row `slot` of the
    batch cache, in place on the device: every attention leaf (k, v, and
    under the int8 cache ks, vs) and each Hyena layer's fir (B, 3, D, K-1)
    and iir (B, D, S, 2) state (batch axis 0 here, where the JAX
    package's stacked states have it on axis 1), and the slot's offset."""
    for dst, srcl in zip(batch_cache['layers'], fill_cache['layers']):
        if isinstance(dst, dict):
            for name, t in dst.items():
                t[slot].copy_(srcl[name][src])
        else:
            dst.fir[slot].copy_(srcl.fir[src])
            dst.iir[slot].copy_(srcl.iir[src])
    batch_cache['offset'][slot:slot + 1].fill_(fill_cache['offset'])


# ---------------------------------------------------------------------------
# Host-side scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Request:
    rid: int
    input_ids: np.ndarray            # (P,) int32
    num_tokens: int
    temperature: float
    seed: int
    top_k: int = 0
    top_p: float = 1.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    logps: List[float] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class GenerationResult:
    """One finished request: generated token ids, the detokenized sequence
    (when the server has a tokenizer), and the mean log-prob of the
    generated tokens under the unfiltered distributions they were sampled
    from, each token's in `logps`. `cancelled` marks a request ended early
    by `cancel()`: token_ids holds what was generated before."""
    rid: int
    token_ids: np.ndarray
    sequence: Optional[str]
    score: float
    cancelled: bool = False
    logps: Optional[np.ndarray] = None


class GenerationServer:
    """Fixed-slot continuous-batching scheduler (module docstring).

    model: an `EvoModel` (`models.py`); the server runs on its device
    and, with the model's mesh, on every rank of it (module docstring).
    max_len bounds prompt + generated tokens of a request. top_k, top_p
    and the temperature are per request (`submit` overrides; the
    constructor's values are the defaults)."""

    def __init__(self, model, tokenizer=None, max_slots: int = 4,
                 max_len: int = 512, top_k: int = 0, top_p: float = 1.0,
                 steps_per_sync: int = 8, stop_token: Optional[int] = None,
                 prompt_chunk: Optional[int] = None,
                 prefill_chunks_per_sync: int = 0,
                 prefill_batch: int = 0, seed: int = 0):
        """prompt_chunk: prefill prompts in chunks of this many tokens
        through the resumed prefill (a head of whole chunks, then a tail of
        1 to prompt_chunk tokens that gives the first token's logits).

        prefill_chunks_per_sync: at most this many prompt chunks run per
        step(), so a long arriving prompt stalls the running decode batch
        by a bounded slice; 0 completes each fill at once. Outputs are the
        same either way.

        prefill_batch: admit up to this many queued prompts of one length
        through one batched prefill. Group sizes come from the power-of-two
        ladder {2, 4, ..., prefill_batch}: a fill takes the largest size
        that the queue's same-length run and the free slots both cover,
        else the B=1 path. Rows never mix, so a request's output does not
        depend on the grouping. 0 or 1 disables.

        seed: the server's seed; each sampled request's generator is
        seeded from it and the request's own seed."""
        if max_slots < 1:
            raise ValueError('max_slots must be >= 1')
        mesh = getattr(model, 'mesh', None)
        if mesh is not None and mesh.replicas > 1:
            raise ValueError('a server spans one model replica: build its '
                             'mesh with parallel.make_mesh')
        self.mesh = mesh
        # ranks kept in step by the lead's broadcasts
        self._ranks = mesh is not None and mesh.size > 1
        self.lead = not self._ranks or mesh.rank == 0
        self._inbox: List[tuple] = []
        self._control: Optional[str] = None
        # this rank's block of slots: [base, base + rows)
        self._rows = dp_rows(max_slots, mesh)
        self._base = (0 if mesh is None else mesh.index('dp')) * self._rows
        self.model = model
        self.cfg = model.config
        self.device = model_lib.resolve_device(model.device)
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_len = max_len
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.stop_token = stop_token
        self.prompt_chunk = prompt_chunk
        self.prefill_chunks_per_sync = max(0, int(prefill_chunks_per_sync))
        self.prefill_batch = max(0, int(prefill_batch))
        self.seed = int(seed)
        # at most one fill (1 or a ladder size of same-length prompts) is
        # mid-prefill at a time: {'slots', 'reqs', 'ids' (k, P), 'pos'}
        self._fill: Optional[dict] = None
        # the last completed B=1 prefill, reused for an identical prompt:
        # {'key': bytes, 'cache', 'last_logits'}
        self._prefix: Optional[dict] = None

        # The JAX package's cache length, so both size the same cache:
        # under `kv_quant: int8` a multiple of 4096 where that pads by at
        # most a quarter, else of 128. self.max_len keeps the user's bound.
        cache_len = max_len
        if self.cfg.kv_quant == 'int8':
            big = -(-max_len // 4096) * 4096
            if max_len >= 4096 and big <= max_len + max_len // 4:
                cache_len = big
            else:
                cache_len = -(-max_len // 128) * 128
        self._cache_len = cache_len
        cache = model.initialize_inference_params(max_slots, cache_len)
        cache['offset'] = torch.zeros((self._rows,), dtype=torch.int32,
                                      device=self.device)
        self._cache = cache
        # scratch prefill caches by row count, written in place by every
        # fill; the batched ones are made at their first fill
        self._prefill_caches = {1: self._fill_cache(1)}
        dev = self.device
        rows = self._rows
        self._tokens = torch.zeros((rows,), dtype=torch.int64, device=dev)
        self._temps = torch.zeros((rows,), dtype=torch.float32, device=dev)
        self._topks = torch.full((rows,), self.top_k, dtype=torch.int32,
                                 device=dev)
        self._topps = torch.full((rows,), self.top_p, dtype=torch.float32,
                                 device=dev)
        # a first token's sampling parameters where the slot is another dp
        # rank's
        self._one = (torch.zeros((1,), dtype=torch.int32, device=dev),
                     torch.zeros((1,), dtype=torch.float32, device=dev),
                     torch.zeros((1,), dtype=torch.float32, device=dev))
        # one generator per sampled local slot, None where it draws nothing
        self._gens: List[Optional[torch.Generator]] = [None] * rows

        self._queue: deque[_Request] = deque()
        # deferred (req, tok0, logp0) of admissions, on the device
        self._pending_first: List[tuple] = []
        self._slots: List[Optional[_Request]] = [None] * max_slots
        self._requests: Dict[int, _Request] = {}
        self._results: Dict[int, GenerationResult] = {}
        self._next_rid = 0

    # -- submission ----------------------------------------------------------

    def submit(self, prompt: Optional[str] = None, input_ids=None,
               num_tokens: int = 32, temperature: float = 0.0,
               seed: Optional[int] = None, top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> int:
        """Queue a generation request; returns its request id.

        seed: the request's sampling seed (default: its request id). A
        request's output is a function of (server seed, request seed,
        prompt, parameters), whatever the other traffic.
        top_k / top_p: per-request overrides of the server's defaults.
        Under ranks, the lead's only."""
        self._refuse_follower('submit')
        if input_ids is None:
            if prompt is None:
                raise ValueError('pass prompt= or input_ids=')
            if self.tokenizer is None:
                raise ValueError('string prompts need a tokenizer')
            input_ids = self.tokenizer.tokenize(prompt)
        ids = np.asarray(input_ids, dtype=np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError('empty prompt')
        if num_tokens < 1:
            raise ValueError('num_tokens must be >= 1')
        if ids.size + num_tokens > self.max_len:
            raise ValueError(
                f'prompt ({ids.size}) + num_tokens ({num_tokens}) exceeds '
                f'the server max_len ({self.max_len})')
        rid = self._next_rid
        req = _Request(rid, ids, int(num_tokens), float(temperature),
                       int(rid if seed is None else seed),
                       top_k=int(self.top_k if top_k is None else top_k),
                       top_p=float(self.top_p if top_p is None else top_p))
        self._enqueue(req)
        if self._ranks:
            self._inbox.append(('submit', rid, ids, req.num_tokens,
                                req.temperature, req.seed, req.top_k,
                                req.top_p))
        return rid

    def _enqueue(self, req: _Request) -> None:
        self._next_rid = req.rid + 1
        self._requests[req.rid] = req
        self._queue.append(req)

    # -- ranks ---------------------------------------------------------------

    def _refuse_follower(self, what: str) -> None:
        if not self.lead:
            raise RuntimeError(
                f'{what}: only rank 0 of the mesh takes requests; the other '
                'ranks follow it (run() or follow())')

    def _sync(self, control: Optional[str] = None) -> bool:
        """The lead broadcasts the requests and cancels it took since the
        last call, with `control` ('end' or 'stop'); the others apply
        them in its order. Returns False on a follower that received a
        control message. Without ranks, True."""
        if not self._ranks:
            return True
        ops, self._control = broadcast_object(
            (self._inbox, control) if self.lead else None)
        if self.lead:
            self._inbox = []
            return True
        for op in ops:
            if op[0] == 'submit':
                rid, ids, n, temp, seed, top_k, top_p = op[1:]
                self._enqueue(_Request(rid, ids, n, temp, seed, top_k=top_k,
                                       top_p=top_p))
            else:
                self._cancel(op[1])
        return self._control is None

    def follow(self) -> None:
        """A follower's loop: step as the lead steps until it stops
        (`stop()`), through the ends of its runs."""
        if self.lead:
            raise RuntimeError('follow() is for the ranks other than 0')
        while self.step() or self._control != 'stop':
            pass

    def stop(self) -> None:
        """On the lead: end the followers' `follow()`."""
        if self._ranks and self.lead:
            self._sync('stop')

    # -- scheduling ----------------------------------------------------------

    def _head_len(self, P: int) -> int:
        """Length of the whole-chunk head of a P-token prompt (the rest is
        the non-empty tail that gives the first token's logits)."""
        if not self.prompt_chunk or P <= self.prompt_chunk:
            return 0
        head = (P // self.prompt_chunk) * self.prompt_chunk
        return head - self.prompt_chunk if head == P else head

    def _insert_from(self, fill_cache, last_logits, slot: int,
                     req: _Request, src: int = 0) -> None:
        """Admit `req` into `slot`: sample its first token from row `src`
        of the fill's last logits with the request's generator and, on the
        slot's dp rank, set the slot's sampling parameters and copy row
        `src` of `fill_cache` into it. The fill cache is only read: it may
        be the prefix cache, and a batched fill's rows are admitted one at
        a time."""
        gen = None
        if req.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(
                _stream_seed(self.seed, req.seed))
        row = slot - self._base
        mine = 0 <= row < self._rows
        if mine:
            s = slice(row, row + 1)
            params = (self._topks[s], self._topps[s], self._temps[s])
        else:
            params = self._one
        params[0].fill_(req.top_k)
        params[1].fill_(req.top_p)
        params[2].fill_(req.temperature)
        tok0, logp0 = _sample_slots(last_logits[src:src + 1, -1], *params,
                                    [gen])
        if mine:
            _admit_slot(self._cache, fill_cache, src, row)
            self._tokens[s].copy_(tok0)
            self._gens[row] = gen
        self._slots[slot] = req
        # the first token stays on the device until the next host
        # observation (_flush_firsts), so admission never waits for it
        self._pending_first.append((req, tok0, logp0))

    def _flush_firsts(self) -> None:
        """Read the deferred first tokens back (one transfer) and record
        them. Runs before any host observation of tokens or results."""
        if not self._pending_first:
            return
        pend, self._pending_first = self._pending_first, []
        vals = torch.stack([
            torch.cat([t for _, t, _ in pend]).double(),
            torch.cat([lp for _, _, lp in pend]).double()]).cpu().numpy()
        for (req, _, _), t, lp in zip(pend, vals[0], vals[1]):
            self._record(req, int(t), float(lp))

    def _service_fills(self) -> None:
        """Start and advance prompt prefills into free slots.

        A request repeating the last B=1 prefill's prompt is admitted from
        that prefill (the prefix cache) with no prefill work; it still
        gets its own generator. A new prompt is prefilled into a scratch
        cache (stale positions past the prompt stay masked by the offset):
        the head in whole chunks through the resumed prefill, then the
        tail. A finished B=1 scratch becomes the prefix cache and the old
        prefix cache the next scratch, so two single-row caches serve
        every B=1 fill; a batched scratch is kept for the next fill of its
        size."""
        budget = self.prefill_chunks_per_sync or float('inf')
        while budget > 0:
            if self._fill is None:
                if not self._start_fill():
                    return
                if self._fill is None:
                    continue                 # prefix-cache admission
            f = self._fill
            if all(r.done for r in f['reqs']):
                self._fill = None            # every row cancelled
                continue
            k = len(f['reqs'])
            ids = f['ids']
            head = self._head_len(int(ids.shape[1]))
            while f['pos'] < head and budget > 0:
                s = f['pos']
                _, self._prefill_caches[k] = self.model(
                    ids[:, s:s + self.prompt_chunk],
                    inference_params_dict=self._prefill_caches[k],
                    donate_cache=True, resume=s > 0, split_dp=False)
                f['pos'] += self.prompt_chunk
                budget -= 1
            if f['pos'] < head:
                return                       # mid-fill; decode goes on
            budget -= 1                      # the tail below
            last_logits, filled = self.model(
                ids[:, head:], inference_params_dict=self._prefill_caches[k],
                donate_cache=True, resume=head > 0, split_dp=False)
            if k == 1:
                self._prefill_caches[1] = (
                    self._prefix['cache'] if self._prefix is not None
                    else self._fill_cache(1))
                self._prefix = {'key': f['reqs'][0].input_ids.tobytes(),
                                'cache': filled,
                                'last_logits': last_logits}
            for src, (slot, req) in enumerate(zip(f['slots'], f['reqs'])):
                if not req.done:             # rows cancelled mid-fill
                    self._insert_from(filled, last_logits, slot, req,
                                      src=src)
            self._fill = None

    def _fill_cache(self, k: int):
        """A zeroed prefill cache of k rows, every row on every dp rank
        (fills run unsplit on each dp replica)."""
        return self.model.initialize_inference_params(k, self._cache_len,
                                                      split_dp=False)

    def _group_size(self, avail: int) -> int:
        """The largest ladder size ({2, 4, ..., prefill_batch}) <= avail,
        or 1."""
        g = 1
        while g * 2 <= min(avail, self.prefill_batch):
            g *= 2
        return g

    def _start_fill(self) -> bool:
        """Take the next request(s) off the queue: a prefix-cache
        admission, a B=1 fill, or a same-length batched fill of a ladder
        size. Returns False when no work can start."""
        free = [i for i, r in enumerate(self._slots) if r is None]
        if not free or not self._queue:
            return False
        req = self._queue.popleft()
        if (self._prefix is not None
                and self._prefix['key'] == req.input_ids.tobytes()):
            self._insert_from(self._prefix['cache'],
                              self._prefix['last_logits'], free[0], req)
            return True
        reqs = [req]
        if self.prefill_batch > 1:
            P = req.input_ids.size
            mates = [r for r in self._queue
                     if r.input_ids.size == P
                     and (self._prefix is None
                          or self._prefix['key'] != r.input_ids.tobytes())]
            g = self._group_size(min(len(free), len(mates) + 1))
            if g > 1:
                for m in mates[:g - 1]:
                    self._queue.remove(m)
                    reqs.append(m)
                if g not in self._prefill_caches:
                    self._prefill_caches[g] = self._fill_cache(g)
        self._fill = {'slots': free[:len(reqs)], 'reqs': reqs,
                      'ids': torch.as_tensor(
                          np.stack([r.input_ids for r in reqs]),
                          device=self.device).long(),
                      'pos': 0}
        return True

    def _record(self, req: _Request, token: int, logp: float) -> None:
        req.tokens.append(token)
        req.logps.append(logp)
        if (len(req.tokens) >= req.num_tokens
                or (self.stop_token is not None
                    and token == self.stop_token)):
            self._finalize(req)

    def _finalize(self, req: _Request, cancelled: bool = False) -> None:
        req.done = True
        ids = np.asarray(req.tokens, dtype=np.int32)
        seq = (self.tokenizer.detokenize(ids.tolist())
               if self.tokenizer is not None else None)
        score = float(np.mean(req.logps)) if req.logps else float('nan')
        self._results[req.rid] = GenerationResult(
            rid=req.rid, token_ids=ids, sequence=seq, score=score,
            cancelled=cancelled,
            logps=np.asarray(req.logps, dtype=np.float32))

    def _free(self, slot: int) -> None:
        self._slots[slot] = None
        if 0 <= slot - self._base < self._rows:
            self._gens[slot - self._base] = None

    def _harvest(self, emitted: np.ndarray, logps: np.ndarray) -> None:
        """emitted, logps: (steps, B) from one decode chunk."""
        self._flush_firsts()     # first tokens precede this chunk's
        for step in range(emitted.shape[0]):
            for slot, req in enumerate(self._slots):
                if req is None or req.done:
                    continue
                self._record(req, int(emitted[step, slot]),
                             float(logps[step, slot]))
        for slot, req in enumerate(self._slots):
            if req is not None and req.done:
                self._free(slot)

    def step(self) -> bool:
        """Advance prompt prefills, then run one decode chunk and read its
        tokens back. Under ranks it starts with the lead's broadcast, and
        returns False on a follower that received an 'end' or a 'stop'
        instead of a step; True otherwise."""
        if not self._sync():
            return False
        self._service_fills()
        for slot, req in enumerate(self._slots):
            if req is not None and req.done:
                self._free(slot)
        if all(r is None for r in self._slots):
            return True
        # idle rows restart at position 0, so they take one key tile of
        # kernel 4 instead of walking toward the end of the cache (fill_,
        # not an item assignment: nothing reads a host scalar); so do the
        # rows past max_slots of the last dp rank's block
        offsets = self._cache['offset']
        for row in range(self._rows):
            slot = self._base + row
            if slot >= self.max_slots or self._slots[slot] is None:
                offsets[row:row + 1].zero_()
        # always exactly steps_per_sync steps: the chunk's shapes and
        # launches stay the same whatever the requests need
        self._tokens, self._cache, emitted, logps = _decode_chunk(
            self.model.module, self._tokens, self._cache, self._topks,
            self._topps, self._temps, self._gens, self.steps_per_sync)
        # the one readback of the chunk: tokens (exact in float64) and
        # log-probs together, every dp rank's slots, (slots, 2, steps)
        out = gather_rows_to_host(
            torch.stack([emitted.double(), logps.double()]).permute(2, 0, 1),
            self.mesh, self.max_slots).numpy()
        self._harvest(out[:, 0].T.astype(np.int64), out[:, 1].T)
        return True

    def run(self) -> Dict[int, GenerationResult]:
        """Drive the loop until every submitted request has finished. Under
        ranks the lead ends the others' `run()` when it is done, and every
        rank returns every result."""
        if self.lead:
            while (self._queue or self._fill is not None
                   or any(r is not None for r in self._slots)):
                self.step()
            self._sync('end')
        else:
            while self.step():
                pass
        self._flush_firsts()
        return dict(self._results)

    # -- results -------------------------------------------------------------

    def result(self, rid: int) -> Optional[GenerationResult]:
        self._flush_firsts()
        return self._results.get(rid)

    def progress(self, rid: int) -> int:
        """Tokens generated so far for request `rid` (0 while queued or
        unknown), host-visible after each step()."""
        self._flush_firsts()
        req = self._requests.get(rid)
        return 0 if req is None else len(req.tokens)

    def tokens_so_far(self, rid: int) -> List[int]:
        """A copy of the tokens generated so far (grows at step()
        granularity; complete once result(rid) exists)."""
        self._flush_firsts()
        req = self._requests.get(rid)
        return [] if req is None else list(req.tokens)

    def cancel(self, rid: int) -> bool:
        """End request `rid` early. True if it was queued, mid-prefill or
        decoding: its result is finalized at once with the tokens so far
        and `cancelled=True`, and its slot frees for the next request.
        False if unknown or already finished. Under ranks, the lead's
        only."""
        self._refuse_follower('cancel')
        done = self._cancel(rid)
        if done and self._ranks:
            self._inbox.append(('cancel', rid))
        return done

    def _cancel(self, rid: int) -> bool:
        self._flush_firsts()
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        if req in self._queue:
            self._queue.remove(req)
        elif self._fill is not None and req in self._fill['reqs']:
            # co-tenant rows keep filling; a fill whose rows are all
            # cancelled is dropped
            if all(r.done or r is req for r in self._fill['reqs']):
                self._fill = None
        else:
            for i, r in enumerate(self._slots):
                if r is req:
                    self._free(i)
                    break
        self._finalize(req, cancelled=True)
        return True

    @property
    def pending(self) -> int:
        filling = (0 if self._fill is None
                   else sum(not r.done for r in self._fill['reqs']))
        return (len(self._queue) + sum(r is not None for r in self._slots)
                + filling)


class ServerLoop:
    """Thread-safe runner of a GenerationServer: a background thread runs
    `server.step()` while work is pending, and any number of caller
    threads (HTTP handlers, `cli/serve.py`) submit requests and wait for
    their own results. Every access to the server holds one lock; a
    decode chunk holds it for its wall time, the intended granularity.

    Under ranks it runs on the lead, whose followers call
    `server.follow()`: while idle it steps every `HEARTBEAT` seconds (an
    empty broadcast), and `close()` stops the followers."""

    def __init__(self, server: GenerationServer):
        self.server = server
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = time.monotonic()
        while True:
            with self._cv:
                while (not self._stop and self.server.pending == 0
                       and not (self.server._ranks and time.monotonic()
                                - last >= HEARTBEAT)):
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    self.server.stop()
                    return
                self.server.step()
                last = time.monotonic()
                self._cv.notify_all()

    def submit(self, **kwargs) -> int:
        with self._cv:
            rid = self.server.submit(**kwargs)
            self._cv.notify_all()
            return rid

    def wait(self, rid: int,
             timeout: Optional[float] = None) -> Optional[GenerationResult]:
        """Block until request `rid` finishes; None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self.server.result(rid) is None:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return None
                self._cv.wait(timeout=0.5 if rem is None else min(rem, 0.5))
            return self.server.result(rid)

    def stream(self, rid: int):
        """Yield request `rid`'s token ids as they become host-visible (in
        bursts of up to steps_per_sync). Ends when the request finishes or
        is cancelled."""
        sent = 0
        while True:
            with self._cv:
                toks = self.server.tokens_so_far(rid)
                done = self.server.result(rid) is not None
                if len(toks) == sent and not done:
                    self._cv.wait(timeout=0.5)
                    continue
            for t in toks[sent:]:
                yield int(t)
            sent = len(toks)
            if done:
                return

    def cancel(self, rid: int) -> bool:
        with self._cv:
            ok = self.server.cancel(rid)
            self._cv.notify_all()
            return ok

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        # under ranks the thread's last act is the followers' stop
        self._thread.join(timeout=None if self.server._ranks else 5)


def serve_requests(model, tokenizer, prompts: Sequence[str],
                   num_tokens: int = 32, temperature: float = 0.0,
                   max_slots: int = 4, max_len: Optional[int] = None,
                   top_k: int = 0, top_p: float = 1.0,
                   steps_per_sync: int = 8, prefill_batch: int = 0,
                   seed: int = 0) -> List[GenerationResult]:
    """Run a ragged list of prompts through one continuous-batching server
    and return the results in submission order. Under a mesh every rank
    calls it with the same arguments: the lead submits the prompts, and
    every rank returns the results."""
    if max_len is None:
        max_len = max(len(p) for p in prompts) + num_tokens + 1
    server = GenerationServer(model, tokenizer, max_slots=max_slots,
                              max_len=max_len, top_k=top_k, top_p=top_p,
                              steps_per_sync=steps_per_sync,
                              prefill_batch=prefill_batch, seed=seed)
    # a fresh server numbers its requests from 0, in submission order
    rids = ([server.submit(prompt=p, num_tokens=num_tokens,
                           temperature=temperature) for p in prompts]
            if server.lead else list(range(len(prompts))))
    results = server.run()
    return [results[r] for r in rids]
