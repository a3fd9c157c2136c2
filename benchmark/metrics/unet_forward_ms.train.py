"""Device ms of the joint step's U-Net forward and diffusion loss (the span
joint.unet), a step of the traced block."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("joint.unet",), "joint.step")
