"""The readings that the limits of `limits/<cell>.json` are set from:
one process runs a cell on many seeds, as the program or as the control
(the program's own lower precision), and prints each run's compared
numbers as one JSON line. Not a benchmark run: the benchmark's command
is `run.py`.

    python3 benchmark/readings.py --workload score-8k-mixed \
        --seconds 10 --seeds 11 12 13 [--control int8x8]

`--control int8x8` runs the program with int8 weights and int8
activations (`weight_quant`, `act_quant`): the program's own path in
the nearest precision below the configurations' bf16; `--control int8w`
with int8 weights alone. `--fault` plants a fault in the program's
scoring for the readings of `score_logp_gap`'s upper end: `pad` counts
one position of padding in every score (`scoring.prepare_batch` hands
back each length plus one), `seam` leaves the tokens at the segments'
seams out of the score (`scoring.logits_to_logprobs` returns nothing for
the previous segment's last position). `--reference 0` makes only the
checks that need no reference.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROLS = {'int8x8': dict(weight_quant='int8', act_quant='int8'),
            'int8w': dict(weight_quant='int8')}


def pad_counted(patch=setattr):
    """The fault `pad`, planted by `patch(object, name, value)`."""
    from evo_tpu_torch import scoring
    prepare = scoring.prepare_batch

    def counted(*a, **kw):
        batch, lengths = prepare(*a, **kw)
        return batch, [n + 1 for n in lengths]
    patch(scoring, 'prepare_batch', counted)


def seams_left_out(patch=setattr):
    """The fault `seam`, planted by `patch(object, name, value)`."""
    from evo_tpu_torch import scoring
    to_logprobs = scoring.logits_to_logprobs

    def left_out(logits, input_ids, trim_bos=True):
        lp = to_logprobs(logits, input_ids, trim_bos=trim_bos)
        return lp if trim_bos else lp[:, :0]
    patch(scoring, 'logits_to_logprobs', left_out)


FAULTS = {'pad': pad_counted, 'seam': seams_left_out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', choices=sorted(CONTROLS))
    ap.add_argument('--fault', choices=sorted(FAULTS))
    ap.add_argument('--reference', type=int, choices=(0, 1), default=1)
    ap.add_argument('--trace', type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        harness.log('no CUDA device')
        return 2
    overrides = CONTROLS[args.control] if args.control else None
    if args.fault:
        FAULTS[args.fault]()
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds,
                             bool(args.trace), 'cuda', overrides=overrides,
                             reference=bool(args.reference))
        print(json.dumps(dict(
            workload=args.workload, seed=seed, control=args.control,
            fault=args.fault,
            correct=r['correct'], attempted=r['attempted'],
            checks={k: v['value'] for k, v in r['checks'].items()},
            metrics={k: v['value'] for k, v in r['metrics'].items()},
            wall_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
