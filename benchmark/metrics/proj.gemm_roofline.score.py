"""The bf16 projections of every traced forward or segment: the sum of
each product's bound (operations at these row counts), over the cuBLAS
bf16 kernels' device time, %."""

from benchmark.readers import gemm_roofline_score as read  # noqa: F401
