"""The port's twins of the JAX package's scripts and examples, at a tiny
size on the CPU:

  * `cli/verify_parity.py`: its outputs on weights carried from the JAX
    package against those of the JAX harness (`scripts.verify_parity.
    compute_outputs`) through `compare` at the harness's tolerance (1e-3),
    both ways; an npz written by either harness read by the other; the
    command line's emit / compare / fingerprint / emitter / manifest
    branches;
  * `cli/generation_to_folding.py`: prodigal stubbed by an executable on
    PATH, ESMFold by a stand-in `transformers` module (nothing is
    downloaded); the proteins FASTA and one PDB a protein, and
    `--skip-folding`;
  * `cli/example_inference.py`, `examples/hello_evo.py` and
    `examples/long_context.py` at the tiny config (the last at 2,000 nt);
  * `cli/score_pod.sh` in its dry-run mode: the torchrun command of each
    node.
"""

import json
import os
import stat
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from evo_tpu import checkpoint as jax_ckpt
from evo_tpu import model as jax_model
from evo_tpu.config import tiny_config as jax_tiny_config
from evo_tpu_torch.checkpoint import params_from_state_dict
from evo_tpu_torch.cli import verify_parity
from evo_tpu_torch.config import tiny_config
from evo_tpu_torch.models import EvoModel
from evo_tpu_torch.tokenizer import CharLevelTokenizer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = ['ACGT', 'CAGATTCCATT', 'GAATTCCGGATTA']


@pytest.fixture(scope='module')
def both_outputs():
    from evo_tpu.models import EvoModel as JaxEvoModel
    from evo_tpu.tokenizer import CharLevelTokenizer as JaxTokenizer
    from scripts.verify_parity import compute_outputs as jax_compute
    jcfg = jax_tiny_config()
    params = jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    want = jax_compute(JaxEvoModel(jcfg, params), JaxTokenizer(512), SEQS,
                       greedy_tokens=8)
    cfg = tiny_config()
    model = EvoModel(cfg, params_from_state_dict(
        jax_ckpt.export_state_dict(params, jcfg), cfg, 'cpu'))
    got = verify_parity.compute_outputs(model, CharLevelTokenizer(512), SEQS,
                                        greedy_tokens=8)
    return got, want


def test_verify_parity_agrees_with_the_jax_harness(both_outputs):
    from scripts.verify_parity import compare as jax_compare
    got, want = both_outputs
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.shape(got[k]) == np.shape(want[k]), k
    assert verify_parity.compare(got, dict(want), 1e-3)
    assert jax_compare(dict(want), got, 1e-3)
    bad = dict(got)
    bad['scores_mean'] = got['scores_mean'] + 1.0
    assert not verify_parity.compare(bad, dict(want), 1e-3)


def test_npz_of_either_harness_reads_in_the_other(both_outputs, tmp_path):
    from scripts.verify_parity import compare as jax_compare
    got, want = both_outputs
    np.savez(tmp_path / 'port.npz', **got)
    np.savez(tmp_path / 'jax.npz', **want)
    port_npz = dict(np.load(tmp_path / 'port.npz', allow_pickle=False))
    jax_npz = dict(np.load(tmp_path / 'jax.npz', allow_pickle=False))
    assert verify_parity.compare(got, jax_npz, 1e-3)
    assert jax_compare(dict(want), port_npz, 1e-3)


def test_verify_parity_command_line(tmp_path, capsys):
    fasta = os.path.join(ROOT, 'examples', 'example_seqs.fasta')
    base = ['--tiny', '--device', 'cpu', '--fasta', fasta,
            '--greedy-tokens', '4']
    npz, fp = str(tmp_path / 'ours.npz'), str(tmp_path / 'fp.json')
    assert verify_parity.main(base + ['--emit-npz', npz,
                                      '--fingerprint', fp]) == 0
    assert verify_parity.main(base + ['--reference-npz', npz,
                                      '--fingerprint-ref', fp]) == 0
    out = capsys.readouterr().out
    assert 'parity: PASS' in out and 'fingerprint: PASS' in out
    with open(fp) as f:
        assert 'embedding' in json.load(f)
    ref = dict(np.load(npz))
    ref['scores_sum'] = ref['scores_sum'] + 1.0
    np.savez(tmp_path / 'bad.npz', **ref)
    assert verify_parity.main(base + ['--reference-npz',
                                      str(tmp_path / 'bad.npz')]) == 1
    emitter = str(tmp_path / 'ref_emit.py')
    assert verify_parity.main(['--write-reference-script', emitter]) == 0
    from scripts.verify_parity import _REFERENCE_EMITTER
    assert open(emitter).read() == _REFERENCE_EMITTER
    assert verify_parity.main(['--manifest']) == 0
    assert 'evo-1-131k-base:' in capsys.readouterr().out


class _FakeEsm:
    """ESMFold's interface as the script uses it, without weights."""

    @classmethod
    def from_pretrained(cls, name):
        assert name == 'facebook/esmfold_v1'
        return cls()

    def to(self, device):
        return self

    def __call__(self, input_ids=None, **kw):
        return input_ids

    def output_to_pdb(self, out):
        return [f'HEADER fake structure of {out.shape[-1]} residues\nEND\n']


class _FakeTokens(dict):
    def to(self, device):
        return self


class _FakeTokenizer:
    @classmethod
    def from_pretrained(cls, name):
        return cls()

    def __call__(self, seqs, return_tensors=None, add_special_tokens=True):
        return _FakeTokens(input_ids=torch.zeros(1, len(seqs[0])))


def _stub_prodigal(tmp_path):
    """An executable named prodigal that writes two proteins to its -a
    path."""
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    exe = bin_dir / 'prodigal'
    exe.write_text('#!/bin/sh\n'
                   'while [ $# -gt 0 ]; do\n'
                   '  if [ "$1" = "-a" ]; then out="$2"; fi\n'
                   '  shift\n'
                   'done\n'
                   'printf ">gene_1 # 1\\nMKVL*\\n>gene/2 # 2\\nMAAGG\\n"'
                   ' > "$out"\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(bin_dir)


@pytest.mark.parametrize('skip', [False, True])
def test_generation_to_folding(tmp_path, monkeypatch, skip):
    from evo_tpu_torch.cli import generation_to_folding
    monkeypatch.setenv('PATH', _stub_prodigal(tmp_path) + os.pathsep
                       + os.environ['PATH'])
    monkeypatch.setitem(sys.modules, 'transformers', types.SimpleNamespace(
        AutoTokenizer=_FakeTokenizer, EsmForProteinFolding=_FakeEsm))
    monkeypatch.chdir(tmp_path)
    argv = ['--tiny', '--device', 'cpu', '--max-new-tokens', '12',
            '--prompt', 'ACGTACGT', '--verbose', '0',
            '--sequence-fasta', 'seq.fasta', '--proteins-fasta',
            'prot.fasta', '--structure-pdb', 'fold.pdb']
    dna, pdbs = generation_to_folding.main(argv + (['--skip-folding']
                                                   if skip else []))
    assert len(dna) == 12
    with open('seq.fasta') as f:
        assert f.read().splitlines()[1] == dna
    assert os.path.exists('prot.fasta')
    if skip:
        assert pdbs == [] and not any(p.endswith('.pdb')
                                      for p in os.listdir('.'))
    else:
        assert pdbs == ['fold_gene_1.pdb', 'fold_gene_2.pdb']
        assert '4 residues' in open('fold_gene_1.pdb').read()


def test_example_inference_tiny(capsys):
    from evo_tpu_torch.cli import example_inference
    logits, batch = example_inference.main(['--tiny', '--device', 'cpu'])
    assert tuple(logits.shape) == (1, 4, 512)
    assert tuple(batch.shape) == (3, 11, 512)
    assert 'Batch logits shape' in capsys.readouterr().out


def test_hello_evo_tiny():
    from evo_tpu_torch.examples import hello_evo
    out = hello_evo.main(['--tiny', '--device', 'cpu'])
    assert len(out['scores']) == 3 and all(s < 0 for s in out['scores'])
    assert len(out['generated']) == 3 and len(out['resumed']) == 48


def test_long_context_short():
    from evo_tpu_torch.examples import long_context
    out = long_context.main(['2000', '256', '--tiny', '--device', 'cpu'])
    assert np.isfinite(out['score']) and len(out['entropies']) == 1999
    assert len(out['generated']) == 64


def test_score_pod_dry_run():
    script = os.path.join(ROOT, 'evo_tpu_torch', 'cli', 'score_pod.sh')
    env = dict(os.environ, NODES='node-a node-b', GPUS_PER_NODE='4', TP='2',
               DRY_RUN='1', MASTER_PORT='29511')
    out = subprocess.run(['bash', script, 'in.fasta', 'out.tsv',
                          'evo-1-131k-base', '/ckpt'], env=env, check=True,
                         capture_output=True, text=True, timeout=60).stdout
    lines = out.strip().splitlines()
    assert len(lines) == 2
    for rank, (line, host) in enumerate(zip(lines, ('node-a', 'node-b'))):
        assert line.startswith(f'{host}: cd ')
        for part in (f'--nnodes 2 --node-rank {rank}', '--nproc-per-node 4',
                     '--master-addr node-a --master-port 29511',
                     '-m evo_tpu_torch.cli.score', '--input-fasta in.fasta',
                     '--output-tsv out.tsv', '--model-name evo-1-131k-base',
                     '--checkpoint-path /ckpt', '--dp -1 --tp 2'):
            assert part in line, (part, line)
    single = subprocess.run(['bash', script, 'in.fasta', 'out.tsv'],
                            env=dict(env, NODES='only'), capture_output=True,
                            text=True, timeout=60)
    assert single.returncode != 0 and 'checkpoint path' in single.stderr
