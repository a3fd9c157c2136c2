"""The NeRF fit step as one CUDA graph (``scripts/fit_torch_nerf.py::train_step``).

A fit step (the gather of the pool's rows, the render, the loss, the
backward through the scatter kernel, the Adam update) launches about a
thousand kernels, each costing the host more than the card.  ``FitGraph``
captures the step once on static buffers and replays it; ``graph_step``
keeps one graph per optimizer and captures it again when the step's key
(``fit_graph_key``) changes.  ``fit_graph_eligible`` says where a graph
may serve; everywhere else the caller runs the step eagerly.

Counters (``utils/profiling.py``): ``fit.graph_replays`` (1 a replayed
step, 0 the capturing call's step, which runs eagerly) and
``fit.graph_captures``; the caller counts ``fit.steps``, and 0 replays
for a step it runs eagerly itself.
"""

from __future__ import annotations

import weakref
from typing import Callable, Sequence, Tuple

import torch

from ..utils.profiling import count


def fit_graph_eligible(opt, budget, custom_bwd: bool, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether a fit step may replay a CUDA graph: every tensor of
    ``tensors`` on one CUDA device, a ``torch.optim.Adam`` built
    ``capturable`` (its step count and learning rate live on the device,
    so a replay reads the schedule's value), a dense step (``budget``
    None) and the encode's scatter backward (``custom_bwd``: the autograd
    path builds its index tables from Python lists, which cannot be
    captured)."""
    dev = tensors[0].device
    return (dev.type == "cuda" and budget is None and custom_bwd
            and isinstance(opt, torch.optim.Adam)
            and all(g.get("capturable", False) for g in opt.param_groups)
            and all(x.device == dev for x in tensors))


def _identity(x):
    return (x.data_ptr(), tuple(x.shape), x.dtype, x.device) if torch.is_tensor(x) else x


def fit_graph_key(opt, settings: Tuple, tensors: Sequence[torch.Tensor],
                  inputs: Sequence[torch.Tensor]) -> Tuple:
    """What a captured step depends on: ``settings`` (the step's Python
    arguments: the config, the ray count, ...), the storage, shape and
    dtype of ``tensors`` (the weights and the ray pool, read where they
    lie), the shape and dtype of ``inputs`` (copied into the graph's
    buffers at each call), and the optimizer's hyper-parameters and state
    tensors."""
    groups = tuple(tuple((k, _identity(v)) for k, v in sorted(g.items()) if k != "params")
                   for g in opt.param_groups)
    state = tuple(tuple((k, _identity(v)) for k, v in sorted(opt.state.get(p, {}).items()))
                  for g in opt.param_groups for p in g["params"])
    return (settings, tuple(_identity(x) for x in tensors),
            tuple((tuple(x.shape), x.dtype) for x in inputs), groups, state)


class FitGraph:
    """One training step, ``fn(*inputs) -> loss`` (forward, backward and
    optimizer update), captured as a CUDA graph on static copies of
    ``inputs`` and replayed call by call.

    Building it runs the call's own step first, eagerly on a side stream,
    as capture needs (library workspaces, lazy initialisation, the
    optimizer's state); its loss is ``first``.  The capture that follows
    runs nothing.  As in PyTorch's whole-network recipe the gradients are
    set to None before it, so the captured backward allocates them from
    the graph's pool and each replay writes them anew; the eager step's
    are copied in, so the gradients read as that step left them."""

    def __init__(self, key_of: Callable[[], Tuple], fn: Callable, opt,
                 inputs: Sequence[torch.Tensor]):
        self.inputs = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.first = fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        params = [p for g in opt.param_groups for p in g["params"]]
        grads = [p.grad for p in params]
        opt.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.loss = fn(*self.inputs)
        for p, g in zip(params, grads):
            if p.grad is not None and g is not None:
                p.grad.copy_(g)
        self.key = key_of()
        count("fit.graph_captures", 1)

    def replay(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The step on ``inputs``; returns its loss, a tensor of its own."""
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.loss.clone()


_GRAPHS = weakref.WeakKeyDictionary()      # optimizer → the FitGraph of its steps


def graph_step(opt, key_of: Callable[[], Tuple], fn: Callable,
               inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One step ``fn(*inputs)`` through the graph kept for ``opt``: a replay
    while ``key_of()`` is the key the graph was captured under, else a new
    capture (the old graph freed first), whose call runs the step
    eagerly.  Returns the step's loss, a tensor of its own."""
    graph = _GRAPHS.get(opt)
    if graph is not None and graph.key == key_of():
        count("fit.graph_replays", 1)
        return graph.replay(inputs)
    _GRAPHS.pop(opt, None)
    graph = _GRAPHS[opt] = FitGraph(key_of, fn, opt, inputs)
    count("fit.graph_replays", 0)
    value, graph.first = graph.first, None
    return value
