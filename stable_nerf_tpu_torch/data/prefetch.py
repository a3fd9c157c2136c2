"""Device prefetch: the copy of the next batches overlaps the step
(counterpart of stable_nerf_tpu/data/prefetch.py, without its sharding
argument, which waits for the parallel paths).

Each host batch is copied into pinned memory and sent to the card with a
``non_blocking`` copy on the current stream, so the host queues batch N+1
while the card still runs the step of batch N.  The pinned source of a
batch is held until the batch has been handed on and the consumer comes
back for the next one.

Spans (``utils/profiling.py``): ``data.next`` over each ``next``, with
``data.load`` (the host iterator: the dataset's reads and collate) and
``data.pin`` (pinning and queueing the copies) inside.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span


def device_prefetch(iterator: Iterator[Dict[str, np.ndarray]], size: int = 2,
                    device: Optional[torch.device] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator (dicts of numpy arrays) with a
    ``size``-deep pipeline of copies to ``device`` (default cuda; raises
    without a card)."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    queue = collections.deque()
    source = iter(iterator)
    done = object()

    def put(batch):
        with span("data.pin"):
            host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            if pin:
                host = {k: v.pin_memory() for k, v in host.items()}
            return {k: v.to(dev, non_blocking=pin) for k, v in host.items()}, host

    while True:
        with span("data.next"):
            while source is not None and len(queue) < size:
                with span("data.load"):
                    batch = next(source, done)
                if batch is done:
                    source = None
                else:
                    queue.append(put(batch))
            if not queue:
                return
            on_device, _host = queue.popleft()
        yield on_device
