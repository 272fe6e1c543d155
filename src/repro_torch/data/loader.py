"""Host-to-device batch staging (port of ``repro.data.loader``).

``ShardedLoader`` draws host batches (dicts of numpy arrays) from a
source and stages each onto the device ahead of use: ``prefetch`` batches
are in flight, so the next batch's copy is queued while the current step
runs.  On a CUDA device the host batch is pinned and copied without
blocking the host.  The reference also splits a batch over a device
mesh; the port's loader takes no mesh until the training mesh (ROADMAP
A9.2) brings one.
"""

from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


class ShardedLoader:
    def __init__(self, source: Iterator[dict], device=None,
                 prefetch: int = 2, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "ShardedLoader over a device mesh is not ported yet "
                "(ROADMAP A9.2)")
        self.source = source
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self._queue: collections.deque = collections.deque()

    def _stage(self, host_batch: dict) -> dict:
        def put(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        return {k: put(v) for k, v in host_batch.items()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while len(self._queue) < self.prefetch:
            self._queue.append(self._stage(next(self.source)))
        return self._queue.popleft()
