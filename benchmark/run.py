"""The benchmark of evo_tpu_torch on one NVIDIA H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: draws the
weights and the traffic from the seed, sets up, measures for `--seconds`,
with `--trace 1` profiles more of the same traffic, checks the outputs
against the plain float32 reference, and prints one JSON object as the
last line of standard output (the numbers compared, with their limits,
under `checks` and as the last lines of standard error). Without a card,
or with fewer cards than the cell asks for, it exits non-zero and prints
no result; so it does when a JAX module has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    # the host's work is one Python thread (and score_stream's prefetch
    # thread): an idle pool of intra-op threads only takes cores from it
    torch.set_num_threads(2)
    cell = harness.load_cell(args.workload)
    chips = cell.workload['chips']
    if not torch.cuda.is_available():
        harness.log('no CUDA device: the benchmark runs on the card only')
        return 2
    if torch.cuda.device_count() < chips:
        harness.log(f'{args.workload} needs {chips} cards, '
                    f'{torch.cuda.device_count()} present')
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), 'cuda', t_start=T_START)
    loaded = result.pop('forbidden_modules')
    if loaded:
        harness.log(f'JAX modules were loaded: {", ".join(loaded)}')
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
