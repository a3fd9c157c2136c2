"""Host ms of the joint step from call to return (the span joint.step): the
time the host takes to enqueue a step, a step of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("joint.step",), "joint.step", clock="host_ms")
