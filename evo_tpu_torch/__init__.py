"""evo_tpu_torch: the PyTorch / CUDA port of evo_tpu for NVIDIA Hopper.

The public calls of the JAX package, with the same contracts: `Evo`,
`score_sequences`, `positional_entropies` and `generate`. Entry points run
on the GPU ("cuda") unless the caller asks for the CPU. RMSNorm, the Hyena
FIR + gate and causal flash attention run as CUDA kernels written for
sm_90a (`csrc/`); on a CPU tensor each takes its plain PyTorch version.

This package imports neither JAX nor `evo_tpu`.
"""

from evo_tpu_torch.generation import generate  # noqa: F401
from evo_tpu_torch.models import Evo  # noqa: F401
from evo_tpu_torch.scoring import (positional_entropies,  # noqa: F401
                                   score_sequences)
