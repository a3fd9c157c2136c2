"""Device ms of the joint step's NeRF render (the span joint.render: march,
network, composite), a step of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("joint.render",), "joint.step")
