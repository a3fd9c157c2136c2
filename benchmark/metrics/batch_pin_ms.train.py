"""Host ms a step spends pinning a batch and queueing its copies to the card
(the span data.pin inside data.next, data/prefetch.py), over the traced
block's steps."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("data.pin",), "data.next", clock="host_ms")
