"""`torch.cuda.max_memory_allocated` over the measured window, after
`reset_peak_memory_stats` at its start, GiB."""

from benchmark.readers import peak_gib as read  # noqa: F401
