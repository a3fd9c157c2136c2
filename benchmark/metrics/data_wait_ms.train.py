"""Host ms a step spent taking its batch from data/prefetch.py (the
harness's span around each next()), the mean over the window."""
from benchmark.metrics._shared import mean_ms


def read(run):
    return mean_ms(run["spans"].get("data_wait"))
