"""K1's least time over its kernel time in the trace, %: its int32 rows
and float32 updates read once and its float32 table written once, over
the HBM peak."""
from benchmark.metrics._shared import scatter_roofline


def read(run):
    return scatter_roofline(run)
