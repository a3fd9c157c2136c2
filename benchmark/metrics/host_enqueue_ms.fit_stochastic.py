"""Host ms of the fit step from call to return (the span fit.step), a step of
the traced block, in the one-corner encode's cell."""
from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("fit.step",), "fit.step", clock="host_ms")
