"""The port's packed-FASTA batches (evo_tpu_torch/io/dataset.py) against
the JAX package's (evo_tpu/io/dataset.py), and the port's fine-tune
command line (evo_tpu_torch/cli/finetune.py) against the flags of
scripts/finetune.py, end to end with `--tiny --device cpu`.

The batches must be equal, element for element, for the same corpus,
seed, epoch and process split.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from evo_tpu.io.dataset import PackedFastaDataset as JaxPackedFastaDataset
from evo_tpu.io.fasta import write_fasta
from evo_tpu_torch import lora, training
from evo_tpu_torch.cli import finetune as finetune_cli
from evo_tpu_torch.io.dataset import PackedFastaDataset
from evo_tpu_torch.models import Evo

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    names, seqs = [], []
    for i in range(9):
        names.append(f'seq{i}')
        seqs.append(''.join(rng.choice(list('ACGT'),
                                       int(rng.integers(20, 90)))))
    path = str(tmp_path / 'corpus.fasta')
    write_fasta(path, names, seqs, width=60)
    return path


@pytest.mark.parametrize('seq_len,batch,seed,count', [
    (16, 1, 0, 1), (32, 2, 5, 1), (16, 2, 1, 3), (7, 3, 2, 2)])
def test_batches_equal_jax(corpus, seq_len, batch, seed, count):
    for index in range(count):
        kw = dict(seq_len=seq_len, batch_size=batch, seed=seed,
                  process_index=index, process_count=count)
        got, want = PackedFastaDataset(corpus, **kw), \
            JaxPackedFastaDataset(corpus, **kw)
        assert got.tokens_per_epoch == want.tokens_per_epoch
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for epoch in (0, 3):
            assert np.array_equal(got.epoch_windows(epoch),
                                  want.epoch_windows(epoch))
            assert np.array_equal(got._epoch_mask, want._epoch_mask)
        pairs = list(zip(got.iter_batches(epochs=2, start_epoch=1),
                         want.iter_batches(epochs=2, start_epoch=1)))
        assert len(pairs) == 2 * want.steps_per_epoch()
        for (ids, mask), (jids, jmask) in pairs:
            assert ids.dtype == np.int32 and mask.dtype == np.float32
            assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)


def test_errors_match_jax(corpus, tmp_path):
    with pytest.raises(ValueError, match='corpus too small'):
        next(PackedFastaDataset(corpus, seq_len=4096, batch_size=8)
             .iter_batches(epochs=None))
    with pytest.raises(ValueError, match='bad process shard'):
        PackedFastaDataset(corpus, process_index=2, process_count=2)
    empty = tmp_path / 'empty.fasta'
    empty.write_text('')
    with pytest.raises(ValueError, match='no sequences'):
        PackedFastaDataset(str(empty))


def test_finetune_flags_match_jax_script():
    """Every flag of scripts/finetune.py under the same name, the defaults
    of the run's shape, and `--device`, 'cuda' unless told."""
    src = open(os.path.join(ROOT, 'scripts', 'finetune.py')).read()
    want = set(re.findall(r"add_argument\('(--[a-z-]+)'", src))
    actions = {a.option_strings[0]: a
               for a in finetune_cli.build_parser()._actions
               if a.option_strings}
    assert set(actions) - {'-h', '--device'} == want
    for flag, default in (
            ('--device', 'cuda'), ('--model-name', 'evo-1-8k-base'),
            ('--seq-len', 8192), ('--batch-size', 1), ('--steps', 100),
            ('--lr', 1e-4), ('--lr-schedule', 'cosine'),
            ('--end-lr-frac', 0.1), ('--weight-decay', 0.01),
            ('--grad-clip', 1.0), ('--lora-rank', 0), ('--lora-alpha', 16.0),
            ('--dp', 1), ('--tp', None), ('--save-every', 0),
            ('--log-every', 10)):
        assert actions[flag].default == default, flag
    with pytest.raises(NotImplementedError, match='parallelism'):
        finetune_cli.main(['--input-fasta', 'x', '--save-dir', 'y', '--tiny',
                           '--device', 'cpu', '--dp', '2'])


def _run(corpus, save, *extra):
    return finetune_cli.main([
        '--input-fasta', corpus, '--tiny', '--device', 'cpu', '--seq-len',
        '16', '--batch-size', '2', '--lr', '1e-3', '--save-dir', save,
        '--log-every', '2', '--lr-schedule', 'constant', *extra])


@pytest.mark.parametrize('mode', ['full', 'lora'])
def test_finetune_cli_end_to_end(corpus, tmp_path, capsys, mode):
    """A tiny run in full and LoRA mode: the loss falls, the train state,
    the serving checkpoint (which loads into Evo and holds the trained
    weights) and, under LoRA, the adapters npz (which the JAX package
    reads) are written; --resume continues from the saved step."""
    save = str(tmp_path / mode)
    extra = ['--lora-rank', '4'] if mode == 'lora' else []
    state = _run(corpus, save, '--steps', '6', *extra)
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r'loss (\S+)', out)]
    assert len(losses) == 3 and losses[-1] < losses[0], out
    assert state.step == 6
    for part in ('train_state', 'serving'):
        assert os.path.isdir(os.path.join(save, part))
    evo = Evo('evo-1-8k-base', 'cpu',
              checkpoint_path=os.path.join(save, 'serving'))
    assert evo.config.hidden_size == 64     # the config saved with it
    if mode == 'full':
        for n, p in evo.model.module.named_parameters():   # read as bf16
            assert torch.equal(p, state.params[n].to(p.dtype)), n
    else:
        import jax
        from evo_tpu import lora as jax_lora
        from evo_tpu import model as jax_model
        from evo_tpu.config import cli_tiny_overrides
        from evo_tpu.models import config_for_model
        from evo_tpu_torch.checkpoint import lora_to_jax
        jcfg = config_for_model('evo-1-8k-base').replace(
            **cli_tiny_overrides())
        template = jax_lora.init_lora(jax.random.PRNGKey(0),
                                      jax_model.init_params(
                                          jax.random.PRNGKey(0), jcfg),
                                      jcfg, rank=4)
        got, alpha = jax_lora.load_lora(os.path.join(save, 'adapters.npz'),
                                        template)
        assert alpha == 16.0
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(lora_to_jax(state.lora))):
            assert np.array_equal(np.asarray(x), y)
        assert any(bool(t.any()) for n, t in
                   lora.named_adapters(state.lora).items()
                   if n.endswith('.b'))
    logits, _ = evo.model(np.asarray(evo.tokenizer.tokenize('ACGT'))[None])
    assert torch.isfinite(logits).all()
    state = _run(corpus, save, '--steps', '8', '--resume', *extra)
    assert 'resumed at step 6' in capsys.readouterr().out
    assert state.step == 8
    assert training.load_train_state(save, state).step == 8


def test_finetune_cli_as_a_module(corpus, tmp_path):
    r = subprocess.run(
        [sys.executable, '-m', 'evo_tpu_torch.cli.finetune', '--input-fasta',
         corpus, '--tiny', '--device', 'cpu', '--seq-len', '16',
         '--batch-size', '2', '--steps', '2', '--log-every', '1',
         '--save-dir', str(tmp_path / 'ft'), '--no-remat'],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert 'done: 2 steps' in r.stdout


def test_finetune_cli_defaults_to_cuda(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        finetune_cli.main(['--input-fasta', corpus, '--tiny', '--save-dir',
                           str(tmp_path / 'ft')])
    assert not os.path.exists(tmp_path / 'ft')
