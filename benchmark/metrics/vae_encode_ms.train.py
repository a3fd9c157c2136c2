"""Device ms of the joint step's VAE encode (the span joint.vae_encode), a
step of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("joint.vae_encode",), "joint.step")
