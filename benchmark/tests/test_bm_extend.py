"""A later cell, traffic mix, configuration or metric is added as files
and entries alone: in a copy of the benchmark, a new mix file, a new
configuration file, a new metric file and a new cell entry are picked up
by the unchanged harness."""

import json
import shutil

from benchmark import harness
from benchmark.tests.tiny import TINY, TRAFFIC


def test_new_files_are_picked_up(tmp_path):
    root = tmp_path
    shutil.copy(f'{harness.ROOT}/BENCHMARK.json', root)
    shutil.copytree(harness.HERE, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    base = root / 'benchmark'
    # a configuration of its own: the 8k model under the fused mixer
    conf = json.loads((base / 'configs' / 'evo-1-8k-base.json').read_text())
    conf['config']['hyena_fused_mixer'] = True
    (base / 'configs' / 'evo-1-8k-fused.json').write_text(json.dumps(conf))
    # a mix of its own for the existing driver
    mix = json.loads((base / 'traffic' / 'batch-mixed.json').read_text())
    mix.update(TRAFFIC['score-8k-mixed'], batch_size=2, min_len=30,
               max_len=90)
    (base / 'traffic' / 'batch-short.json').write_text(json.dumps(mix))
    (base / 'metrics' / 'score.batches_per_s.py').write_text(
        'def read(record):\n'
        '    c = record.counters\n'
        '    return c["batches"] / c["window_s"] if "batches" in c else None\n')
    (base / 'limits' / 'score-8k-short.json').write_text(json.dumps(
        json.loads((base / 'limits' / 'score-8k-mixed.json').read_text())))
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['configs'].append(dict(spec['configs'][0], name='evo-1-8k-fused',
                                file='benchmark/configs/evo-1-8k-fused.json'))
    spec['workloads'].append(dict(name='score-8k-short',
                                  config='evo-1-8k-fused',
                                  traffic='batch-short', chips=1,
                                  why='a test cell'))
    spec['end_to_end'][0]['workloads'].append('score-8k-short')
    spec['per_layer'].append(dict(
        name='score.batches_per_s', unit='batches/s', better='higher',
        source='host_clock', layer='scoring', moves='score_nt_per_s',
        workloads=['score-8k-short']))
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))

    r = harness.run_cell('score-8k-short', 5, 1.0, True, 'cpu',
                         overrides=TINY, root=str(root), base=str(base))
    assert r['correct'], r['checks']
    assert r['metrics']['score.batches_per_s']['value'] > 0
    r = harness.run_cell('score-8k-short', 5, 1.0, False, 'cpu',
                         overrides=TINY, root=str(root), base=str(base))
    assert set(r['metrics']) == {'score_nt_per_s', 'setup_s'}
