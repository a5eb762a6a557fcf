"""1 - the union of the device's operations over the traced window's
host-clock length, %."""

from benchmark.readers import idle_share as read  # noqa: F401
