"""Device time of the traced window in kernels that are neither library
products nor the port's own kernels (the long conv's plain float32
passes and `cat` copies, the MLP's elementwise passes), over all device
time, %."""

from benchmark.readers import plain_ops_share as read  # noqa: F401
