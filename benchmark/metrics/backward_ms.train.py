"""Device ms of the joint step's backward (the span joint.backward), a step
of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("joint.backward",), "joint.step")
