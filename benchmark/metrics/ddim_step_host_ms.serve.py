"""Host ms of one DDIM step (the span infer.ddim_step), the mean over the
traced request's steps: against ddim_step_device_ms.serve, how far the
host's dispatch paces the denoise."""
from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "infer.ddim_step", "infer.request", clock="host_ms")
