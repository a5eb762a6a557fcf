"""The plain float32 reference against the port at the tiny size: the
same weights (the benchmark's draw, loaded into the port through
`checkpoint.params_from_state_dict`) give the same logits, fresh and
under rotary interpolation, for several lengths."""

import json
import os

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import striped_hyena
from benchmark.tests.tiny import TINY


def _cfg(config_file, **extra):
    path = os.path.join(harness.HERE, 'configs', config_file)
    with open(path) as f:
        return dict(json.load(f)['config'], **TINY, **extra)


@pytest.mark.parametrize('config_file', ['evo-1-8k-base.json',
                                         'evo-1-131k-base.json'])
@pytest.mark.parametrize('length', [1, 2, 3, 65, 300])
def test_reference_matches_the_port(config_file, length):
    from evo_tpu_torch import model as model_lib
    from evo_tpu_torch.config import ModelConfig
    cfg = _cfg(config_file)
    sd = weights.draw(cfg, 11, 'cpu', torch.float32)
    module = harness.build_program(ModelConfig.from_dict(cfg), sd,
                                   torch.device('cpu')).module
    g = torch.Generator().manual_seed(length)
    ids = torch.randint(0, 512, (length,), generator=g)
    with torch.no_grad():
        want = model_lib.forward(module, ids[None])[0]
    got = striped_hyena.logits(sd, cfg, ids)
    assert got.shape == (length, cfg['vocab_size'])
    assert float((got - want).abs().max()) < 1e-4


def test_reference_reads_none_of_the_programs_state():
    # the reference's inputs are the drawn state dict and the ids alone
    cfg = _cfg('evo-1-8k-base.json')
    sd = weights.draw(cfg, 3, 'cpu', torch.float32)
    ids = torch.arange(40) % 4 + 65
    a = striped_hyena.logits(sd, cfg, ids)
    b = striped_hyena.logits(weights.draw(cfg, 3, 'cpu', torch.float32),
                             cfg, ids)
    assert torch.equal(a, b)


def test_next_token_logprobs_pair_each_position_with_the_next_token():
    cfg = _cfg('evo-1-8k-base.json')
    sd = weights.draw(cfg, 5, 'cpu', torch.float32)
    ids = torch.tensor([0, 65, 67, 71, 84, 65])
    lp = torch.log_softmax(striped_hyena.logits(sd, cfg, ids), -1)
    got = striped_hyena.next_token_logprobs(sd, cfg, ids)
    assert torch.allclose(got, lp[torch.arange(5), ids[1:]])


def test_long_conv_matches_the_direct_sum():
    g = torch.Generator().manual_seed(0)
    L, C, S = 37, 5, 3
    u = torch.randn(L, C, generator=g)
    poles = torch.randn(C, S, 2, generator=g) * 0.5
    residues = torch.randn(C, S, 2, generator=g)
    d = torch.randn(C, generator=g)
    y = striped_hyena.long_conv(u, poles, residues, d)
    p = torch.complex(poles[..., 0].double(), poles[..., 1].double())
    r = torch.complex(residues[..., 0].double(), residues[..., 1].double())
    want = torch.zeros(L, C, dtype=torch.float64)
    for t in range(L):
        for tau in range(t + 1):
            h = torch.real((r * p ** (t - tau)).sum(-1))
            want[t] += h * u[tau].double()
    want += d.double() * u.double()
    err = (y.double() - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) < 1e-6


def test_weights_follow_the_seed_and_the_layouts():
    from evo_tpu_torch.checkpoint import expected_state_dict_spec
    from evo_tpu_torch.config import ModelConfig
    cfg = _cfg('evo-1-8k-base.json')
    a = weights.draw(cfg, 2 ** 40 + 1, 'cpu', torch.bfloat16)
    b = weights.draw(cfg, 2 ** 40 + 1, 'cpu', torch.bfloat16)
    c = weights.draw(cfg, 2 ** 40 + 2, 'cpu', torch.bfloat16)
    assert weights.fingerprint(a) == weights.fingerprint(b)
    assert weights.fingerprint(a) != weights.fingerprint(c)
    spec = expected_state_dict_spec(ModelConfig.from_dict(cfg))
    assert {k: tuple(v.shape) for k, v in a.items()} == spec
    poles = a['blocks.0.filter.poles'].float()
    mag = poles.pow(2).sum(-1).sqrt()
    assert poles.dtype == torch.float32
    assert 0.6 <= float(mag.min()) and float(mag.max()) <= 0.99
