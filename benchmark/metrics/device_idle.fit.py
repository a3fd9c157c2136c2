"""Share of the traced block with no kernel, copy or fill on the device, %."""
from benchmark.metrics._shared import device_idle


def read(run):
    return device_idle(run)
