"""Where greedy tokens of the card and the CPU part, and by how much the
two candidates differ there, for the small bf16 model and the server run
of `tests/test_torch_cuda.py::test_greedy_server_on_the_card_matches_the_cpu`:

    python3 evo_tpu_torch/tools/greedy_ties.py

Runs the server on the card with kernel 4's split (twice), with its
mainloop at few rows (`SPLIT_MAX_ROWS_BF16 = 0`), and on the CPU with 2
threads (as the test runs) and with PyTorch's default count, prints every
request's tokens, then, where the split's tokens part from the 2-thread
CPU's and from the mainloop's, the top-3 logits of one forward over the
prompt and the common tokens, on the CPU (2 threads) and on the card: two
candidates closer than one bf16 step (2^-8 near 1) are a tie that any
order of sums may break either way.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from evo_tpu_torch import model as model_lib  # noqa: E402
from evo_tpu_torch.config import tiny_config  # noqa: E402
from evo_tpu_torch.models import EvoModel  # noqa: E402
from evo_tpu_torch.ops import attention_buffer as ab  # noqa: E402
from evo_tpu_torch.serving import GenerationServer  # noqa: E402
from evo_tpu_torch.tokenizer import CharLevelTokenizer  # noqa: E402

def main():
    if not torch.cuda.is_available():
        sys.stderr.write('greedy_ties: no CUDA device\n')
        return 1
    cfg = tiny_config(hidden_size=256, num_filters=256, num_attention_heads=2,
                      compute_dtype='bfloat16', param_dtype='bfloat16')
    module = model_lib.random_init(cfg, torch.Generator(device='cuda')
                                   .manual_seed(0), 'cuda')
    tok = CharLevelTokenizer(512)
    prompts = ['ACGTACGTAGGCTTAC' * 9, 'TTGGCCAATTGGA' * 3, 'GATTACA' * 20,
               'CCGTAAGT' * 4, 'ACGT' * 33]
    lens = [12, 7, 9, 10, 8]

    def serve(m):
        server = GenerationServer(m, tok, max_slots=2, max_len=256,
                                  steps_per_sync=4, prompt_chunk=64)
        rids = [server.submit(prompt=p, num_tokens=n)
                for p, n in zip(prompts[:3], lens[:3])]
        server.step()
        rids += [server.submit(prompt=p, num_tokens=n)
                 for p, n in zip(prompts[3:], lens[3:])]
        results = server.run()
        return [np.asarray(results[r].token_ids) for r in rids]

    runs = {}
    runs['card split'] = serve(EvoModel(cfg, module))
    runs['card split again'] = serve(EvoModel(cfg, module))
    keep = ab.SPLIT_MAX_ROWS_BF16
    ab.SPLIT_MAX_ROWS_BF16 = 0
    runs['card mainloop'] = serve(EvoModel(cfg, module))
    ab.SPLIT_MAX_ROWS_BF16 = keep
    cpu_module = model_lib.random_init(cfg, torch.Generator(device='cuda')
                                       .manual_seed(0), 'cuda').to('cpu')
    threads = torch.get_num_threads()
    runs[f'cpu, {threads} threads'] = serve(EvoModel(cfg, cpu_module))
    torch.set_num_threads(2)
    runs['cpu'] = serve(EvoModel(cfg, cpu_module))
    for k, v in runs.items():
        print(k, [t.tolist() for t in v])
    for i, (a, b) in enumerate(zip(runs['card split'], runs['cpu'])):
        diff = np.nonzero(a != b)[0]
        if not len(diff):
            continue
        j = int(diff[0])
        ids = np.concatenate([tok.tokenize(prompts[i]), b[:j]])[None]
        for name, m in (('cpu', EvoModel(cfg, cpu_module)),
                        ('card', EvoModel(cfg, module))):
            logits = m(torch.as_tensor(ids, device=m.device).long())[0][
                0, -1].float().cpu()
            top = torch.topk(logits, 3)
            print(f'request {i} token {j}: {name} forward top-3 '
                  f'{top.indices.tolist()} {top.values.tolist()}; logit std '
                  f'{float(logits.std()):.3f}; card split chose {int(a[j])} '
                  f'({float(logits[int(a[j])]):.4f}), cpu chose {int(b[j])} '
                  f'({float(logits[int(b[j])]):.4f})')
    # where the card's two designs part: the margin of that step
    for i, (a, b) in enumerate(zip(runs['card split'],
                                   runs['card mainloop'])):
        diff = np.nonzero(a != b)[0]
        if not len(diff):
            continue
        j = int(diff[0])
        ids = np.concatenate([tok.tokenize(prompts[i]), b[:j]])[None]
        for name, m in (('cpu', EvoModel(cfg, cpu_module)),
                        ('card', EvoModel(cfg, module))):
            logits = m(torch.as_tensor(ids, device=m.device).long())[0][
                0, -1].float().cpu()
            top = torch.topk(logits, 3)
            print(f'split against mainloop, request {i} token {j}: {name} '
                  f'forward top-3 {top.indices.tolist()} '
                  f'{top.values.tolist()}; split chose {int(a[j])} '
                  f'({float(logits[int(a[j])]):.4f}), mainloop {int(b[j])} '
                  f'({float(logits[int(b[j])]):.4f})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
