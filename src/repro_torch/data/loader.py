"""Host-to-device batch staging (port of ``repro.data.loader``).

``ShardedLoader`` draws host batches (dicts of numpy arrays) from a
source and stages each onto the device ahead of use: ``prefetch`` batches
are in flight, so the next batch's copy is queued while the current step
runs.  On a CUDA device the host batch is pinned and copied without
blocking the host.  Given a mesh (``models.partitioning.Mesh``) every
rank draws the same global batch and stages only its rows: its block
of the leading axis over the batch axes ("pod", "data") read row-major,
the rows the reference's ``PartitionSpec(("pod", "data"))`` puts on it.
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
        self.source = source
        self.mesh = mesh
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self._queue: collections.deque = collections.deque()

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's block of ``x``'s rows (all of them off a mesh)."""
        if self.mesh is None:
            return x
        n = self.mesh.fsdp_size()
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {n} ranks of the batch axes")
        b = x.shape[0] // n
        return x[self.mesh.fsdp_index() * b:(self.mesh.fsdp_index() + 1) * b]

    def _stage(self, host_batch: dict) -> dict:
        def put(x):
            t = torch.from_numpy(np.ascontiguousarray(self._rows(x)))
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
