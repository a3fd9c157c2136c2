"""The occupancy refresh's ms (the harness's span, between two
synchronizes), the mean over the window's refreshes."""
from benchmark.metrics._shared import mean_ms


def read(run):
    return mean_ms(run["spans"].get("grid_refresh"))
