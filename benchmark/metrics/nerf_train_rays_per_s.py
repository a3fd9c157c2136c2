"""Rays trained in the window over its seconds."""
from benchmark.metrics._shared import rays_per_s


def read(run):
    return rays_per_s(run)
