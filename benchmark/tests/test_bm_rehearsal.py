"""Each cell's control flow at the tiny size on the port's plain paths,
through the harness's own entry with the device set to the CPU (the
command itself refuses without a card)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS, run

ROOT = harness.ROOT


@pytest.mark.parametrize('cell', CELLS)
def test_untraced_run_reports_its_end_to_end_metrics(cell):
    r = run(cell)
    spec = harness.load_spec()
    e2e, _ = harness.cell_metrics(spec, cell)
    assert r['correct'], r['checks']
    assert set(r['metrics']) == {m['name'] for m in e2e}
    assert all(m['value'] > 0 for m in r['metrics'].values())
    assert list(r)[-1] == 'checks'
    assert r['attempted'] > 0 and r['failed'] == 0
    assert r['device']['platform'] == 'cpu'


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_reads_the_host_side_per_layer_metrics(cell):
    # on the CPU the trace holds no device operation: the readers of
    # the device trace find nothing and say so; the rest read
    r = run(cell, trace=True)
    assert r['correct'], r['checks']
    _, per_layer = harness.cell_metrics(harness.load_spec(), cell)
    names = {m['name'] for m in per_layer}
    assert set(r['metrics']) <= names
    host = {m['name'] for m in per_layer
            if m['source'] in ('host_clock', 'program_counter')
            and not m['name'].startswith('peak_gib')}
    assert host <= set(r['metrics'])
    assert r['device']['busy_s'] == 0.0 and 'breakdown' in r


def test_command_refuses_without_a_card(tmp_path):
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'benchmark', 'run.py'),
         '--workload', 'score-8k-mixed', '--seed', str(2 ** 33 + 5),
         '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert p.returncode != 0
    assert p.stdout.strip() == '' or not p.stdout.strip().splitlines()[-1] \
        .startswith('{')


def test_command_fails_outside_a_checkout(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'score-8k-mixed',
         '--seed', '7', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != 'PYTHONPATH'})
    assert p.returncode != 0
    assert not any(line.startswith('{') for line in p.stdout.splitlines())


def test_result_line_is_one_json_object():
    r = run('score-131k-segmented')
    line = json.dumps(r)
    assert '\n' not in line
    assert set(r) >= {'correct', 'attempted', 'failed', 'metrics', 'device'}
