"""The port's `evo_tpu_torch/utils.py` against `evo_tpu/utils.py`, function
by function, on the same inputs: the constants and codon tables equal,
`reverse_complement` and the deep mutational scan equal, the BLAST / ERPIN
/ hmmsearch parsers giving equal frames on the same text, and
`permutation_test` the same P value from the same seed. Neither module
touches JAX; the port's copy stands alone (tests/test_torch_hygiene.py)."""

import numpy as np
import pandas as pd
import pytest

import evo_tpu.utils as jax_utils
import evo_tpu_torch.utils as utils


@pytest.mark.parametrize('name', ['NTs', 'AAs', 'CODON_TO_AA', 'AA_TO_CODON',
                                  'AA_3_TO_1'])
def test_constants_and_tables_equal(name):
    assert getattr(utils, name) == getattr(jax_utils, name)


def test_codon_table_is_the_standard_code():
    assert len(utils.CODON_TO_AA) == 64
    assert utils.CODON_TO_AA['ATG'] == 'M'
    assert sorted(utils.AA_TO_CODON['*']) == ['TAA', 'TAG', 'TGA']
    assert sum(len(v) for v in utils.AA_TO_CODON.values()) == 64


@pytest.mark.parametrize('seq', ['ACGT', 'aacgtnN', 'GATTACA' * 9, ''])
def test_reverse_complement(seq):
    assert utils.reverse_complement(seq) == jax_utils.reverse_complement(seq)


@pytest.mark.parametrize('ignore_wt', [True, False])
def test_deep_mutational_scan(ignore_wt):
    seq = 'ACGTTAGC'
    got = list(utils.nucleotide_deep_mutational_scan(seq, ignore_wt))
    assert got == list(jax_utils.nucleotide_deep_mutational_scan(
        seq, ignore_wt))
    assert len(got) == len(seq) * (3 if ignore_wt else 4)


def _same_frame(a, b):
    pd.testing.assert_frame_equal(a, b)


def test_parse_blast_output(tmp_path):
    path = tmp_path / 'blast.tsv'
    path.write_text('# BLASTN 2.14\n'
                    'q1\ts1\t98.5\t200\t3\t0\t1\t200\t11\t210\t1e-50\t350\n'
                    '\n'
                    'q2\ts9\t77.0\t50\t11\t1\t5\t54\t100\t149\t0.002\t40.1\n')
    got = utils.parse_blast_output(str(path))
    _same_frame(got, jax_utils.parse_blast_output(str(path)))
    assert list(got['evalue']) == [1e-50, 0.002] and len(got.columns) == 12
    empty = tmp_path / 'empty.tsv'
    empty.write_text('# nothing\n')
    _same_frame(utils.parse_blast_output(str(empty)),
                jax_utils.parse_blast_output(str(empty)))


def test_parse_erpin_output(tmp_path):
    path = tmp_path / 'erpin.out'
    path.write_text('>tRNA_hit\n'
                    'FW 1 10..80 23.5 1.2e-5\n'
                    'ACGTACGTAC\n'
                    '>other\n'
                    'RC 2 5..9 3.0 4.0\n'
                    'GGG\n'
                    '>tRNA_hit\n'
                    'RC 3 100..160 19.0 3e-3\n'
                    'TTTTAAAA\n')
    for name in ('tRNA_hit', 'other', 'missing'):
        _same_frame(utils.parse_erpin_output(str(path), name),
                    jax_utils.parse_erpin_output(str(path), name))
    got = utils.parse_erpin_output(str(path), 'tRNA_hit')
    assert list(got['strand']) == ['+', '-'] and list(got['start']) == [10, 100]


def test_parse_hmmsearch_output(tmp_path):
    path = tmp_path / 'hits.domtbl'
    row = ' '.join(['t1', '-', '120', 'PF00001', 'PF00001.2', '100', '1e-20',
                    '70.1', '0.1', '1', '1', '1e-22', '1e-20', '69.9', '0.1',
                    '1', '99', '5', '110', '3', '112', '0.97',
                    'a multi word description'])
    path.write_text('# target name\n' + row + '\n' + row.replace('t1', 't2')
                    + '\n')
    got = utils.parse_hmmsearch_output(str(path))
    _same_frame(got, jax_utils.parse_hmmsearch_output(str(path)))
    assert list(got['desc']) == ['a multi word description'] * 2


@pytest.mark.parametrize('seed', [0, 7])
def test_permutation_test_same_seed_same_p(seed):
    rng = np.random.default_rng(100)
    x1, x2 = rng.standard_normal(30), rng.standard_normal(30) + 0.4

    def score(a, b):
        return float(np.corrcoef(a, b)[0, 1])

    got = utils.permutation_test(score, x1, x2, n_permutations=500,
                                 rng=np.random.default_rng(seed))
    want = jax_utils.permutation_test(score, x1, x2, n_permutations=500,
                                      rng=np.random.default_rng(seed))
    assert got == want and 0.0 <= got <= 1.0
    for mod in (utils, jax_utils):
        with pytest.raises(ValueError, match='positive'):
            mod.permutation_test(score, x1, x2, n_permutations=0)
