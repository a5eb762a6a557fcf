"""The port's command lines (evo_tpu_torch/cli) against the JAX package's
(scripts/score.py, scripts/generate.py), on the CPU with `--tiny`.

Both CLIs make their `--tiny` model from a seed with their own generator,
so for the comparisons the port's `random_init` is replaced by one that
carries the JAX package's weights of the same seed across the state-dict
bridge: argument parsing, FASTA reading, batching, bucketing, scoring,
generation and the written output are each package's own. Scores agree
within 1e-5 (float32), greedy tokens exactly.
"""

import csv
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import ModelConfig as JaxModelConfig
from evo_tpu.scoring import next_bucket as jax_next_bucket
from evo_tpu_torch import models
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.cli import generate as generate_cli
from evo_tpu_torch.cli import score as score_cli
from evo_tpu_torch.config import cli_quant_overrides
from evo_tpu_torch.models import Evo
from evo_tpu_torch.scoring import (next_bucket, score_sequences,
                                   score_stream)
from scripts import generate as jax_generate_cli
from scripts import score as jax_score_cli

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FASTA = os.path.join(ROOT, 'examples', 'example_seqs.fasta')
TINY = ['--tiny', '--device', 'cpu']


@pytest.fixture
def jax_weights(monkeypatch):
    """Make the port's random init return the JAX package's weights of the
    same config and seed."""
    def random_init(cfg, generator, device, mesh=None):
        fields = {f for f in JaxModelConfig.__dataclass_fields__}
        jcfg = JaxModelConfig(**{k: v for k, v in vars(cfg).items()
                                 if k in fields}, use_pallas='never')
        params = jax_model.init_params(
            jax.random.PRNGKey(generator.initial_seed()), jcfg)
        return params_from_state_dict(
            jax_ckpt.export_state_dict(params, jcfg), cfg, device, mesh)

    monkeypatch.setattr(models.model_lib, 'random_init', random_init)


def _read_tsv(path):
    with open(path) as f:
        rows = list(csv.reader(f, delimiter='\t'))
    assert rows[0] == ['seqs', 'scores']
    return [r[0] for r in rows[1:]], [float(r[1]) for r in rows[1:]]


@pytest.mark.parametrize('extra', [
    [], ['--no-bucket', '--batch-size', '2', '--reduce-method', 'sum'],
    ['--segment-len', '16']], ids=['default', 'no-bucket-sum', 'segments'])
def test_score_cli_matches_jax_cli(tmp_path, monkeypatch, jax_weights,
                                   capsys, extra):
    ours, theirs = str(tmp_path / 'ours.tsv'), str(tmp_path / 'theirs.tsv')
    score_cli.main(TINY + ['--input-fasta', FASTA, '--output-tsv', ours]
                   + extra)
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', [
        'score', '--tiny', '--input-fasta', FASTA, '--output-tsv', theirs]
        + extra)
    jax_score_cli.main()
    want_out = capsys.readouterr().out
    (seqs, scores), (want_seqs, want) = _read_tsv(ours), _read_tsv(theirs)
    assert seqs == want_seqs and len(seqs) == 3
    np.testing.assert_allclose(scores, want, rtol=1e-5)
    assert out.replace(ours, 'X') == want_out.replace(theirs, 'X')


def test_generate_cli_matches_jax_cli(monkeypatch, jax_weights, capsys):
    args = ['--prompt', 'ACGTACGT', '--n-samples', '2', '--n-tokens', '6',
            '--temperature', '0', '--top-k', '1', '--seed', '0']
    seqs, scores = generate_cli.main(TINY + args)
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['generate', '--tiny'] + args)
    want_seqs, want = jax_generate_cli.main()
    want_out = capsys.readouterr().out
    assert seqs == want_seqs and seqs[0] == seqs[1]
    np.testing.assert_allclose(scores, want, rtol=1e-5)

    def lines(text):      # 'Prompt: "...",\tOutput: "...",\tScore: x'
        return [ln.rsplit('Score: ', 1)[0] for ln in text.splitlines()
                if ln.startswith('Prompt: ')]

    assert lines(out) == lines(want_out) and len(lines(out)) == 2


@pytest.mark.parametrize('temperature,top_k', [('0', '1'), ('1.0', '4')],
                         ids=['greedy', 'sampled'])
def test_speculative_cli_matches_jax_cli(monkeypatch, jax_weights, capsys,
                                         temperature, top_k):
    """`--speculative 4 --ngram 3` through both scripts: one
    `generate_speculative` call a sample with seed `--seed + i`, the same
    sequences, scores within 1e-5 and the same verbose lines (acceptance
    and tokens a device call); a sampled run draws from
    np.random.default_rng in both packages."""
    args = ['--prompt', 'ACGTACGTACGT', '--n-samples', '2', '--n-tokens',
            '10', '--temperature', temperature, '--top-k', top_k,
            '--seed', '3', '--speculative', '4', '--ngram', '3']
    seqs, scores = generate_cli.main(TINY + args)
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['generate', '--tiny'] + args)
    want_seqs, want = jax_generate_cli.main()
    want_out = capsys.readouterr().out
    assert seqs == want_seqs and all(len(s) == 10 for s in seqs)
    np.testing.assert_allclose(scores, want, rtol=1e-5)

    def lines(text):   # 'Output: "...", Score: x (acceptance a, t ...)'
        got = [re.match(r'Output: "(.*)", Score: (\S+) (\(.*\))$', ln)
               for ln in text.splitlines() if ln.startswith('Output: ')]
        return [(m[1], float(m[2]), m[3]) for m in got]

    ours, theirs = lines(out), lines(want_out)
    assert len(ours) == 2
    assert [(a, c) for a, _, c in ours] == [(a, c) for a, _, c in theirs]
    np.testing.assert_allclose([b for _, b, _ in ours],
                               [b for _, b, _ in theirs], atol=1e-4)


@pytest.mark.parametrize('cli,flag', [
    (score_cli, ['--dp', '2']), (score_cli, ['--tp', '2']),
    (score_cli, ['--cp', '2']), (generate_cli, ['--dp', '2']),
    (generate_cli, ['--tp', '2']), (generate_cli, ['--cp', '2'])],
    ids=lambda v: v[0] if isinstance(v, list) else v.__name__.rsplit('.')[-1])
def test_unported_flags_raise(tmp_path, cli, flag):
    """--dp / --tp / --cp above 1 need one process a rank and say how to
    launch them (--cp is ported: tests/test_torch_context_parallel.py)."""
    base = (['--input-fasta', FASTA, '--output-tsv', str(tmp_path / 'x')]
            if cli is score_cli else ['--prompt', 'ACGT'])
    with pytest.raises(ValueError, match='torchrun'):
        cli.main(TINY + base + flag)
    # at their defaults the same flags want no ranks
    args = cli.build_parser().parse_args(base + ['--tp', '1'])
    assert score_cli.start_ranks(args) is False


@pytest.mark.parametrize('script,cli', [('score.py', score_cli),
                                        ('generate.py', generate_cli)])
def test_flags_and_defaults_match_jax_scripts(script, cli):
    """Every flag of the JAX script, under the same name and with the same
    default, save `--device`: honoured here, 'cuda' unless told; the port
    adds `--dist-backend` (its process groups' backend)."""
    src = open(os.path.join(ROOT, 'scripts', script)).read()
    want = set(re.findall(r"add_argument\('(--[a-z-]+)'", src))
    actions = {a.option_strings[0]: a
               for a in cli.build_parser()._actions if a.option_strings}
    assert set(actions) - {'-h', '--dist-backend'} == want
    assert actions['--dist-backend'].default is None
    assert actions['--device'].default == 'cuda'
    for flag, default in (('--model-name', 'evo-1-8k-base'),
                          ('--quant', 'none'), ('--kv-quant', 'none'),
                          ('--tp', None), ('--dp', 1)):
        assert actions[flag].default == default
    assert actions['--quant'].choices == ['none', 'int8', 'int8x8', 'int4']
    if cli is score_cli:
        assert actions['--batch-size'].default == 32
    else:
        assert (actions['--n-samples'].default,
                actions['--n-tokens'].default,
                actions['--top-k'].default) == (3, 100, 4)


@pytest.mark.parametrize('quant', ['int8', 'int8x8', 'int4'])
def test_quant_flags_reach_the_model(tmp_path, monkeypatch, quant):
    """--quant and --kv-quant become config overrides and quantized
    layers; scores stay near the unquantized ones (tiny random weights:
    int8 within 0.02, int4 within 0.1 of a mean log-likelihood)."""
    built = []
    real = score_cli.Evo
    monkeypatch.setattr(score_cli, 'Evo', lambda *a, **k: built.append(
        real(*a, **k)) or built[-1])
    out = str(tmp_path / 'q.tsv')
    _, scores = score_cli.main(TINY + [
        '--input-fasta', FASTA, '--output-tsv', out, '--quant', quant,
        '--kv-quant', 'int8', '--segment-len', '32'])
    cfg = built[0].config
    assert (cfg.weight_quant, cfg.act_quant, cfg.kv_quant) == (
        quant.replace('x8', ''), 'int8' if quant == 'int8x8' else 'none',
        'int8')
    assert built[0].model.module.blocks[1].attn.wqkv.mode == cfg.weight_quant
    _, plain = score_cli.main(TINY + ['--input-fasta', FASTA,
                                      '--output-tsv', out])
    assert _read_tsv(out)[1] == plain
    np.testing.assert_allclose(scores, plain,
                               atol=0.1 if quant == 'int4' else 0.02)
    seqs, gen = generate_cli.main(TINY + [
        '--prompt', 'ACGT', '--n-samples', '1', '--n-tokens', '4',
        '--temperature', '0', '--top-k', '1', '--quant', quant,
        '--kv-quant', 'int8', '--verbose', '0'])
    assert len(seqs[0]) == 4 and np.isfinite(gen).all()


def test_quant_overrides_and_their_checks():
    assert cli_quant_overrides('none') == {}
    assert cli_quant_overrides('int8') == {'weight_quant': 'int8'}
    assert cli_quant_overrides('int4') == {'weight_quant': 'int4'}
    assert cli_quant_overrides('int8x8') == {'weight_quant': 'int8',
                                             'act_quant': 'int8'}
    with pytest.raises(ValueError, match='unknown --quant'):
        cli_quant_overrides('int2')
    tiny = score_cli.cli_tiny_overrides()
    with pytest.raises(ValueError, match='requires weight_quant: int8'):
        Evo('evo-1-8k-base', 'cpu', random_init=True,
            config_overrides=dict(tiny, act_quant='int8'))
    with pytest.raises(ValueError, match='requires weight_quant: int8'):
        Evo('evo-1-8k-base', 'cpu', random_init=True,
            config_overrides=dict(tiny, act_quant='int8',
                                  weight_quant='int4'))
    with pytest.raises(ValueError, match='unknown weight_quant'):
        Evo('evo-1-8k-base', 'cpu', random_init=True,
            config_overrides=dict(tiny, weight_quant='fp8'))
    with pytest.raises(ValueError, match='unknown act_quant'):
        Evo('evo-1-8k-base', 'cpu', random_init=True,
            config_overrides=dict(tiny, act_quant='int4'))


def test_clis_default_to_cuda_and_never_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        score_cli.main(['--tiny', '--input-fasta', FASTA, '--output-tsv',
                        str(tmp_path / 'x.tsv')])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        generate_cli.main(['--tiny', '--prompt', 'ACGT'])
    assert not os.path.exists(tmp_path / 'x.tsv')


@pytest.mark.parametrize('module,args', [
    ('evo_tpu_torch.cli.score', ['--input-fasta', FASTA, '--output-tsv',
                                 '{tmp}/s.tsv', '--quant', 'int4']),
    ('evo_tpu_torch.cli.generate', ['--prompt', 'ACGT', '--n-tokens', '8',
                                    '--temperature', '0', '--top-k', '1',
                                    '--quant', 'int4', '--kv-quant',
                                    'int8'])], ids=['score', 'generate'])
def test_cli_as_a_module(tmp_path, module, args):
    """`python -m evo_tpu_torch.cli.<name>` end to end in a process of its
    own."""
    args = [a.replace('{tmp}', str(tmp_path)) for a in args]
    r = subprocess.run([sys.executable, '-m', module] + TINY + args,
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    if module.endswith('score'):
        seqs, scores = _read_tsv(tmp_path / 's.tsv')
        assert len(seqs) == 3 and all(s < 0 for s in scores)
        assert 'Scoring 3 sequences...' in r.stdout
    else:
        assert r.stdout.count('Output: "') == 3


def test_score_stream_matches_score_sequences():
    evo = Evo('evo-1-8k-base', 'cpu', random_init=True,
              config_overrides=score_cli.cli_tiny_overrides())
    rng = np.random.default_rng(0)
    seqs = [''.join(rng.choice(list('ACGT'), n)) for n in (5, 40, 33, 7, 64)]
    want = []
    for i in range(0, len(seqs), 2):
        want += score_sequences(seqs[i:i + 2], evo.model, evo.tokenizer)
    seen = []
    got = score_stream([seqs[i:i + 2] for i in range(0, len(seqs), 2)],
                       evo.model, evo.tokenizer, progress=seen.append)
    assert seen == [2, 4, 5]
    # bucketing pads further to the right, which a causal model ignores
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        score_sequences(seqs, evo.model, evo.tokenizer, pad_to_bucket=True),
        score_sequences(seqs, evo.model, evo.tokenizer), rtol=1e-5)
    assert score_stream([], evo.model, evo.tokenizer) == []
    with pytest.raises(ValueError, match='reduce_method'):
        score_stream([seqs], evo.model, evo.tokenizer, reduce_method='max')
    for n in (1, 32, 33, 64, 65, 5000):
        assert next_bucket(n) == jax_next_bucket(n)
