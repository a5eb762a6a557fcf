"""evo_tpu_torch: the PyTorch / CUDA port of evo_tpu for NVIDIA Hopper.

The public calls of the JAX package, with the same contracts: `Evo`,
`score_sequences`, `positional_entropies`, their `_segmented` twins for
long sequences, `generate`, `generate_speculative` (n-gram speculative
decoding, `speculative.py`) and `__version__`. Entry points run on the GPU ("cuda") unless
the caller asks for the CPU. RMSNorm, the Hyena FIR + gate, causal flash
attention, attention over the KV buffer (bf16 and int8) and the weight-only
int4 matmul run as CUDA kernels written for sm_90a (`csrc/`); on a CPU
tensor each takes its plain PyTorch version. Weights come from a seed or
from a checkpoint on disk (`checkpoint.py`), optionally quantized
(`quant.py`). `GenerationServer` and `serve_requests` serve ragged,
staggered generation requests by continuous batching (`serving.py`);
`python -m evo_tpu_torch.cli.score`, `...cli.generate` and `...cli.serve`
are the command lines. `runtime.py` holds the debug and tracing controls,
`io/` the FASTA reader (with its native scanner) and the prefetch thread
of `score_stream`. Fine-tuning lives in `training.py` (float32 masters,
AdamW, the train step), `lora.py` (adapters), `io/dataset.py` (packed
FASTA batches) and `python -m evo_tpu_torch.cli.finetune`; like the JAX
package, the top level exports none of their names.

This package imports neither JAX nor `evo_tpu`.
"""

from evo_tpu_torch.generation import generate  # noqa: F401
from evo_tpu_torch.models import Evo  # noqa: F401
from evo_tpu_torch.scoring import (positional_entropies,  # noqa: F401
                                   positional_entropies_segmented,
                                   score_sequences,
                                   score_sequences_segmented)
from evo_tpu_torch.serving import (GenerationServer,  # noqa: F401
                                   serve_requests)
from evo_tpu_torch.speculative import generate_speculative  # noqa: F401
from evo_tpu_torch.version import version as __version__  # noqa: F401
