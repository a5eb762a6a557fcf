"""Model FLOPs of the window's positions (`roofline.sequence_flops`:
the admitted prompts and the generated tokens, attention at each
position's context, the long conv left out) over the window over the
bf16 peak (989 TFLOP/s at 700 W), %."""

from benchmark.readers import mfu as read  # noqa: F401
