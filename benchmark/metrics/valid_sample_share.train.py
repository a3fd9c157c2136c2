"""Samples the march found valid over the samples the network evaluated
(the renderer's counters render.valid_samples and render.samples), over the
traced block, %."""
from benchmark.metrics._spans import counter_share


def read(run):
    return counter_share(run, "render.valid_samples", "render.samples")
