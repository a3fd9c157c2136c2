"""Device ms of one DDIM step (the span infer.ddim_step: the U-Net and the
scheduler update), the mean over the traced request's steps."""
from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "infer.ddim_step", "infer.request")
