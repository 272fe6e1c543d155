"""The serving worker group (port of ``repro.launch.mesh``'s
``make_worker_mesh``).

One process per coded-worker rank: rank r of W owns the contiguous
block r of the worker-major coded streams (DESIGN.md §13), so a
straggling or Byzantine worker is an actual process and the decode tail
gathers only survivor shards.  The reference's training meshes, its
production serving mesh (16 workers x 16-way tensor parallel) and the
"model" and "pod" axes are not ported.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.models.partitioning import WorkerGroup


def make_worker_mesh(workers: int) -> WorkerGroup:
    """The "worker" axis over the default process group, which must hold
    exactly ``workers`` processes (``torch.distributed`` is initialised by
    the caller, as ``launch.multihost.initialize`` does)."""
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed before building a "
                           "worker group")
    have = dist.get_world_size()
    if have != workers:
        raise ValueError(f"worker group of {workers} ranks needs as many "
                         f"processes, the process group has {have}")
    return WorkerGroup()
