"""The active worker group (port of the worker-axis part of
``repro.models.partitioning``).

The reference shards the coded streams over the "worker" axis of a JAX
device mesh, and ``active_mesh()`` tells the serving code at trace time
whether it runs on such a mesh.  Here a worker rank is one
``torch.distributed`` process: ``worker_group_context`` makes a process
group the active worker group, and ``active_group()`` returns it (or
None off any group).  ``WorkerGroup`` wraps the three collectives the
worker-sharded decode tail needs and counts the bytes each moves, by
op, as the reference's ``hlo_analysis.collective_bytes`` counts them in
the compiled program.  The data and model axes (tensor parallelism) are
not ported.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

# The single-tensor collectives, by the name this torch gives them: 2.13
# renamed them (``*_single``; the old names warn), older releases have
# only the old names.  Same signatures.
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class WorkerGroup:
    """A ``torch.distributed`` process group as the "worker" axis: rank r
    of W owns the r-th contiguous block of the worker-major streams.

    ``bytes`` accumulates each collective's per-rank traffic under the
    ring algorithm, with B the output bytes of the op and n the group
    size (the reference's accounting): all-gather B (n-1)/n,
    reduce-scatter B (n-1) (B the scattered output), all-reduce
    2 B (n-1)/n.  A one-rank group moves nothing and counts nothing.
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("a worker group needs torch.distributed "
                               "initialised (init_process_group)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.bytes: Dict[str, float] = collections.defaultdict(float)

    def _count(self, op: str, out: torch.Tensor, factor: float) -> None:
        if self.size > 1:
            self.bytes[op] += out.numel() * out.element_size() * factor

    def collective_bytes(self) -> Dict[str, float]:
        """{op: bytes} moved so far, plus "total"."""
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out

    def reset_bytes(self) -> None:
        self.bytes.clear()

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * xm.shape[0],) + xm.shape[1:],
                          dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, xm, group=self.group)
        self._count("all-gather", out, (self.size - 1) / self.size)
        return out.movedim(0, dim % x.dim())

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``, of which rank r keeps the r-th of
        W equal blocks of the last axis."""
        w = self.size
        v = x.shape[-1]
        if v % w:
            raise ValueError(f"cannot scatter a last axis of {v} over "
                             f"{w} ranks")
        blocks = x.unflatten(-1, (w, v // w)).movedim(-2, 0).contiguous()
        out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out, blocks.flatten(0, 1), group=self.group)
        self._count("reduce-scatter", out, w - 1)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x`` (a new tensor)."""
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        self._count("all-reduce", out, 2.0 * (self.size - 1) / self.size)
        return out


class _Ctx(threading.local):
    def __init__(self):
        self.group: Optional[WorkerGroup] = None


_CTX = _Ctx()


@contextlib.contextmanager
def worker_group_context(group: WorkerGroup):
    """Make ``group`` the active worker group (the reference's
    ``logical_sharding_context`` over a worker mesh)."""
    prev = _CTX.group
    _CTX.group = group
    try:
        yield group
    finally:
        _CTX.group = prev


def active_group() -> Optional[WorkerGroup]:
    """The group of the enclosing ``worker_group_context`` (or None): the
    serving code's choice between the worker-sharded tail and the
    one-rank path, as ``active_mesh()`` is the reference's."""
    return _CTX.group
