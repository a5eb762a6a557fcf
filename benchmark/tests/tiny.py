"""Tiny sizes of every cell for the CPU rehearsals: the configuration's
schema at hidden size 64 and four layers (attention at 1), float32, and
short mixes."""

TINY = dict(hidden_size=64, num_filters=64, num_layers=4,
            attn_layer_idxs=[1], hyena_layer_idxs=[0, 2, 3],
            num_attention_heads=4, state_size=4, compute_dtype='float32',
            param_dtype='float32')

TRAFFIC = {
    'score-8k-mixed': dict(min_len=100, max_len=500, batch_size=4,
                           traced_batches=1),
    'serve-8k-design': dict(max_slots=8, clients=3, prompt_len=[20, 60],
                            output_len=[20, 60], max_len=256,
                            steps_per_sync=4, prompt_chunk=16,
                            traced_steps=2),
    'score-131k-segmented': dict(seq_len=1000, segment_len=256),
}

CELLS = sorted(TRAFFIC)
SEED = 2 ** 31 + 12345


def run(cell, seconds=1.0, trace=False, overrides=None, seed=SEED,
        traffic=None, **kw):
    from benchmark import harness
    return harness.run_cell(cell, seed, seconds, trace, 'cpu',
                            overrides=dict(TINY, **(overrides or {})),
                            traffic=traffic or TRAFFIC[cell], **kw)
