"""Device time of the traced window in kernels that no pattern of
`kernel_layers.json` names, over all device time, %."""

from benchmark.readers import unmapped_share as read  # noqa: F401
