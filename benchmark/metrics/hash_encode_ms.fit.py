"""Device ms of the hash encode in a fit step: its forward and its backward
(the spans nerf.hash_encode and nerf.hash_encode_backward inside fit.step),
a step of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("nerf.hash_encode", "nerf.hash_encode_backward"), "fit.step")
