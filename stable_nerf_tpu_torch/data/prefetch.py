"""Device prefetch: the copy of the next batches overlaps the step
(counterpart of stable_nerf_tpu/data/prefetch.py, without its sharding
argument, which waits for the parallel paths).

Each host batch is copied into pinned memory and sent to the card with a
``non_blocking`` copy on the current stream, so the host queues batch N+1
while the card still runs the step of batch N.  The pinned source of a
batch is held until the batch has been handed on and the consumer comes
back for the next one.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def device_prefetch(iterator: Iterator[Dict[str, np.ndarray]], size: int = 2,
                    device: Optional[torch.device] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator (dicts of numpy arrays) with a
    ``size``-deep pipeline of copies to ``device`` (default cuda; raises
    without a card)."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    queue = collections.deque()

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        return {k: v.to(dev, non_blocking=pin) for k, v in host.items()}, host

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            on_device, _host = queue.popleft()
            yield on_device
    while queue:
        on_device, _host = queue.popleft()
        yield on_device
