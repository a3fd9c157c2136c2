"""DDIM steps that replayed the step's CUDA graph over the steps run (the
serving path's counters infer.ddim_graph_replays and infer.ddim_steps),
over the traced block, %."""
from benchmark.metrics._spans import counter_share


def read(run):
    return counter_share(run, "infer.ddim_graph_replays", "infer.ddim_steps")
