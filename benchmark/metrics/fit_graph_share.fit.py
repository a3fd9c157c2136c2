"""Fit steps that replayed the step's CUDA graph over the steps run (the
fit step's counters fit.graph_replays and fit.steps), over the traced
block, %."""
from benchmark.metrics._spans import counter_share


def read(run):
    return counter_share(run, "fit.graph_replays", "fit.steps")
