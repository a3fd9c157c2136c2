"""A request's counted FLOPs over the window's request time and the
dense bf16 peak, %."""
from benchmark.metrics._shared import mfu


def read(run):
    return mfu(run, "requests")
