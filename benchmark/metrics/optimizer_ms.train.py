"""Device ms of the joint step's AdamW update, zero_grad and lr schedule
(the span joint.optimizer), a step of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("joint.optimizer",), "joint.step")
