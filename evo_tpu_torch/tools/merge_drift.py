"""How far `lora.merge_lora`'s bf16 rounding moves the logits, against
phase 5's yardstick of `chip_smoke.py`, on a narrow model of evo-1's
depth on the CPU:

    python3 evo_tpu_torch/tools/merge_drift.py [--hidden 512] [--length 512]

A random-init evo-1-8k-base config (seed 0) cut to `--hidden` channels
(heads of 128) at all 32 layers, in bf16 with remat; rank-8 adapters on
the seven default targets trained 4 steps at lr 1e-3 on one batch of
random DNA (`--length` + 1 tokens, seed 0), as phase 19 trains them.
Prints one JSON line: the losses, the mean and largest |logit| distance of
the merged model from the attached adapters, the same for the attached
model with one bf16 rounding step (a relative 2^-8 of random sign) on
layer 0's first norm (the yardstick), their ratio and the argmax
agreement. A CPU run: it says how the two roundings compare, not how fast
anything runs.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from evo_tpu_torch import lora, model as model_lib, training
    from evo_tpu_torch.config import EVO_1_8K_BASE, ModelConfig
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--hidden', type=int, default=512)
    p.add_argument('--length', type=int, default=512)
    args = p.parse_args()
    D = args.hidden
    cfg = ModelConfig.from_dict(EVO_1_8K_BASE).replace(
        hidden_size=D, num_filters=D, num_attention_heads=D // 128,
        hyena_layer_idxs=(), remat=True)
    model = model_lib.random_init(cfg, torch.Generator().manual_seed(0),
                                  'cpu')
    ids = torch.from_numpy(np.random.default_rng(0).choice(
        np.frombuffer(b'ACGT', np.uint8), (1, args.length + 1))
        .astype(np.int64))
    sign = torch.randint(0, 2, (1, 1, D),
                         generator=torch.Generator().manual_seed(3))

    def nudged():
        hook = model.blocks[0].pre_norm.register_forward_hook(
            lambda mod, inp, out: out * (1 + (2 * sign - 1) * 2.0 ** -8).to(
                out.dtype))
        out = model_lib.forward(model, ids)
        hook.remove()
        return out

    adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=8)
    opt = training.make_optimizer(learning_rate=1e-3)
    state = lora.init_lora_train_state(adapters, opt)
    step = lora.make_lora_train_step(model, opt, alpha=16.0)
    losses = []
    for _ in range(4):
        state, loss = step(state, ids)
        losses.append(float(loss))
    lora.attach_lora(model, state.lora, 16.0)
    attached = model_lib.forward(model, ids)
    floor = (nudged() - attached).abs()
    lora.detach_lora(model)
    merged = model_lib.forward(lora.merge_lora(model, state.lora, 16.0),
                               ids)
    diff = (merged - attached).abs()
    print(json.dumps(dict(
        hidden=D, length=args.length, losses=losses,
        merge_mean_abs=float(diff.mean()), merge_max_abs=float(diff.max()),
        yardstick_mean=float(floor.mean()),
        yardstick_max=float(floor.max()),
        ratio=float(diff.mean() / floor.mean()),
        argmax_agreement=float((merged.argmax(-1) == attached.argmax(-1))
                               .float().mean()))))


if __name__ == '__main__':
    main()
