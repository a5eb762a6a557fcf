"""CLI: continuous-batching generation over JSONL or HTTP (the flags,
defaults and output of the JAX package's `scripts/serve.py`).

Batch mode (default): JSONL requests in, JSONL results out, in order.

    python -m evo_tpu_torch.cli.serve --requests-jsonl reqs.jsonl \
        --output-jsonl out.jsonl --max-slots 8 --quant int8
    # each input line: {"prompt": "ACGT...", "num_tokens": 256,
    #                   "temperature": 0.7}   (id, top_k, top_p optional)

HTTP mode: a stdlib ThreadingHTTPServer whose handler threads submit into
one scheduler and wait for their own result, while `ServerLoop` keeps the
decode batch moving.

    python -m evo_tpu_torch.cli.serve --http 8000 &
    curl -s localhost:8000/generate -d \
        '{"prompt": "ACGT", "num_tokens": 64, "temperature": 0.7}'
    curl -s localhost:8000/health

`--device` is honoured and defaults to `cuda`; `--tiny --device cpu` runs a
tiny model of the same schema on the CPU.

Across ranks, one process a card as torchrun launches them, `--dp`,
`--tp` and `--cp` make one (dp, cp, tp) mesh of every rank, as the JAX
script's flags make one over a host's chips:

    torchrun --nproc-per-node 2 -m evo_tpu_torch.cli.serve --tp 2 \
        --requests-jsonl reqs.jsonl --output-jsonl out.jsonl

Rank 0 reads the requests (or serves HTTP) and writes the results; the
other ranks follow its schedule (`serving.GenerationServer`).
`--dist-backend gloo` runs several ranks on one card (NCCL refuses that).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from evo_tpu_torch.cli.score import (add_mesh_flags, build_overrides,
                                     start_ranks)
from evo_tpu_torch.models import Evo
from evo_tpu_torch.serving import GenerationServer, ServerLoop


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='Continuous-batching generation server (PyTorch / '
                    'CUDA).')
    p.add_argument('--model-name', default='evo-1-8k-base')
    p.add_argument('--checkpoint-path', default=None)
    p.add_argument('--random-init', action='store_true')
    p.add_argument('--tiny', action='store_true',
                   help='tiny same-schema model (CPU smoke; implies '
                        '--random-init)')
    p.add_argument('--device', default='cuda',
                   help='where the model runs: cuda (default) or cpu')
    p.add_argument('--quant', default='none',
                   choices=['none', 'int8', 'int8x8', 'int4'])
    p.add_argument('--kv-quant', default='none', choices=['none', 'int8'],
                   help='int8 attention KV cache: halves per-slot cache '
                        'memory and the cache reads of a decode step '
                        '(opt-in)')
    add_mesh_flags(p)
    # server shape
    p.add_argument('--max-slots', type=int, default=8)
    p.add_argument('--max-len', type=int, default=8192)
    p.add_argument('--steps-per-sync', type=int, default=32)
    p.add_argument('--prompt-chunk', type=int, default=128,
                   help='prefill prompts in chunks of this many tokens; '
                        '0 disables')
    p.add_argument('--prefill-chunks-per-sync', type=int, default=0,
                   help='interleave long-prompt prefill with decode: at '
                        'most N prompt chunks per scheduler step; 0 = '
                        'finish each prefill at once')
    p.add_argument('--prefill-batch', type=int, default=8,
                   help='admit up to N same-length queued prompts in one '
                        'batched prefill (power-of-two group sizes); 0 '
                        'disables')
    p.add_argument('--top-k', type=int, default=0)
    p.add_argument('--top-p', type=float, default=1.0)
    p.add_argument('--stop-token', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    # request defaults
    p.add_argument('--n-tokens', type=int, default=128)
    p.add_argument('--temperature', type=float, default=0.0)
    # transport
    p.add_argument('--requests-jsonl', default='-',
                   help="JSONL request file, '-' = stdin (batch mode)")
    p.add_argument('--output-jsonl', default='-')
    p.add_argument('--http', type=int, default=None,
                   help='serve HTTP on this port instead of batch mode')
    p.add_argument('--request-timeout', type=float, default=600.0)
    return p


def build_server(args) -> GenerationServer:
    """The model of the flags and a server over it; under --dp / --tp /
    --cp, on this rank's part of a mesh of every rank (one process a
    rank: a single process with a flag above 1 raises)."""
    mesh = None
    if start_ranks(args):
        from evo_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp, tp=args.tp, cp=args.cp)
    overrides = build_overrides(args)
    evo = Evo(args.model_name, args.device,
              checkpoint_path=args.checkpoint_path,
              random_init=args.random_init, config_overrides=overrides,
              mesh=mesh)
    return GenerationServer(evo.model, evo.tokenizer,
                            **server_settings(args))


def server_settings(args) -> dict:
    """The `GenerationServer` keywords of the flags."""
    return dict(max_slots=args.max_slots, max_len=args.max_len,
                top_k=args.top_k, top_p=args.top_p,
                steps_per_sync=args.steps_per_sync,
                stop_token=args.stop_token,
                prompt_chunk=args.prompt_chunk or None,
                prefill_chunks_per_sync=args.prefill_chunks_per_sync,
                prefill_batch=args.prefill_batch, seed=args.seed)


def _submit_kwargs(args, req: dict) -> dict:
    return dict(
        prompt=req['prompt'],
        num_tokens=int(req.get('num_tokens', args.n_tokens)),
        temperature=float(req.get('temperature', args.temperature)),
        top_k=(int(req['top_k']) if 'top_k' in req else None),
        top_p=(float(req['top_p']) if 'top_p' in req else None))


def _result_line(rid, req_id, res) -> str:
    out = {
        'id': req_id if req_id is not None else rid,
        'sequence': res.sequence,
        'num_tokens': int(len(res.token_ids)),
        'score': res.score,
    }
    if res.cancelled:
        out['cancelled'] = True
    return json.dumps(out)


def run_jsonl(args, server: GenerationServer) -> None:
    fin = sys.stdin if args.requests_jsonl == '-' \
        else open(args.requests_jsonl)
    with fin:
        requests = [json.loads(line) for line in fin if line.strip()]
    rids = [server.submit(**_submit_kwargs(args, req)) for req in requests]
    results = server.run()
    fout = sys.stdout if args.output_jsonl == '-' \
        else open(args.output_jsonl, 'w')
    with fout:
        for req, rid in zip(requests, rids):
            fout.write(_result_line(rid, req.get('id'), results[rid]) + '\n')


def make_http_server(args, server: GenerationServer):
    """(httpd, loop), without entering serve_forever. Paths: POST
    /generate (one JSON result), POST /stream (NDJSON: one line a token,
    then the result), POST /cancel {"id": N}, GET /health."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    loop = ServerLoop(server)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._send(200, {'ok': True, 'pending': loop.server.pending})
            else:
                self._send(404, {'error': 'unknown path'})

        def _read_json(self) -> dict:
            length = int(self.headers.get('Content-Length', 0))
            return json.loads(self.rfile.read(length) or b'{}')

        def do_POST(self):
            if self.path == '/cancel':
                try:
                    rid = int(self._read_json()['id'])
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._send(400, {'error': str(e)})
                    return
                self._send(200, {'id': rid, 'cancelled': loop.cancel(rid)})
                return
            if self.path not in ('/generate', '/stream'):
                self._send(404, {'error': 'unknown path'})
                return
            try:
                req = self._read_json()
                rid = loop.submit(**_submit_kwargs(args, req))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send(400, {'error': str(e)})
                return
            if self.path == '/stream':
                # chunked: one JSON line per token as the decode chunks
                # make them host-visible, then the completed result
                self.send_response(200)
                self.send_header('Content-Type', 'application/x-ndjson')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()

                def chunk(payload: dict) -> None:
                    body = (json.dumps(payload) + '\n').encode()
                    self.wfile.write(f'{len(body):x}\r\n'.encode()
                                     + body + b'\r\n')
                try:
                    for tok in loop.stream(rid):
                        chunk({'id': rid, 'token': tok})
                    res = loop.server.result(rid)
                    chunk(json.loads(_result_line(rid, req.get('id'), res)))
                    self.wfile.write(b'0\r\n\r\n')
                except BrokenPipeError:
                    loop.cancel(rid)     # the client went away: free the slot
                return
            res = loop.wait(rid, timeout=args.request_timeout)
            if res is None:
                self._send(504, {'error': 'timed out', 'id': rid})
                return
            self._send(200, json.loads(_result_line(rid, req.get('id'),
                                                    res)))

        def log_message(self, fmt, *a):     # no access log
            pass

    return ThreadingHTTPServer(('', args.http), Handler), loop


def run_http(args, server: GenerationServer) -> None:
    httpd, loop = make_http_server(args, server)
    print(f'serving on :{httpd.server_address[1]} '
          f'(max_slots={server.max_slots}, max_len={server.max_len})',
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        loop.close()


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    server = build_server(args)
    if not server.lead:
        # the other ranks of a mesh step as rank 0 steps
        if args.http is not None:
            server.follow()
        else:
            server.run()
        return
    if args.http is not None:
        run_http(args, server)
    else:
        run_jsonl(args, server)


if __name__ == '__main__':
    main()
