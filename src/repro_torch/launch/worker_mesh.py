"""Worker-axis sharding of the coded stream pool (port of
``repro.launch.worker_mesh``, DESIGN.md §13).

ApproxIFER's premise is that the N+1 coded queries of a group run on
distinct workers; here a worker is a rank of the active mesh's "worker"
axis (``models.partitioning``), one ``torch.distributed`` process each,
or, on a (worker, model) mesh, a row of processes that splits the
model's heads, MLP and vocabulary over its "model" axis: the logits
reach the tail whole, gathered over the model axis inside the model
(``models.layers.unembed``), and the collectives below run on the
worker axis's subgroup.
Coded streams are laid out worker-major: the flat stream axis is
``(N+1, G)`` flattened, so rank r of W owns the contiguous streams of
workers ``[r*nl, (r+1)*nl)``, nl = (N+1)/W, and holds only those: it
encodes them (``ops.berrut_encode_dispatch`` on its rows of the encode
matrix), runs the model on them and keeps their caches.  The decode
tail gathers only survivor shards:

  1. every rank scatters its local streams into a ``(width, G, V)``
     buffer at their survivor-compacted slot (non-survivors land in a
     spill row that is dropped),
  2. one reduce-scatter over the vocabulary sums the buffers, moving
     ``width/(N+1)`` of the bytes an all-gather of the coded block
     would, and leaves each rank a vocabulary shard of the compacted
     block,
  3. the fused decode contracts the compacted ``(G, width, V/W)`` block
     against the survivor-compacted Berrut basis (compaction keeps
     stream order, and the survivor weights' signs depend only on the
     survivor rank), and
  4. sampling runs on the vocabulary shard (hierarchical argmax, merged
     top-k, with the tie-breaks of ``sampling.sample_tokens``), so no
     rank holds the full decoded logits; the token ids come back the
     same on every rank.

With W = 1 (no active group, or a one-rank group) the same compacted
math runs without collectives, so tokens are bit-identical across worker
counts; ``mode="replicated"`` keeps the all-gather-everything baseline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import berrut
from repro_torch.core.berrut import CodingConfig
from repro_torch.kernels import ops
from repro_torch.models import partitioning
from repro_torch.models.partitioning import WorkerGroup
from repro_torch.serving.sampling import (SampleConfig, sample_tokens,
                                         top_k_stable)


@dataclasses.dataclass(frozen=True)
class WorkerShardConfig:
    """Worker-sharding policy of a serving run.

    gather_width: survivor slots gathered at decode.  ``None`` resolves
    to ``coding.decode_quorum``, the most streams a round waits for under
    the scheduler's default policy.  If a straggler mask ever carries more
    survivors than the width, only the first ``width`` (lowest worker
    index) are decoded; schedulers that wait beyond the quorum must widen
    it explicitly (they raise otherwise).

    mode: "survivor" (masked gather of <= width shards) or "replicated"
    (all-gather of all N+1 streams, the baseline).
    """

    axis: str = "worker"
    gather_width: Optional[int] = None
    mode: str = "survivor"

    def __post_init__(self):
        if self.mode not in ("survivor", "replicated"):
            raise ValueError(f"unknown worker-shard mode {self.mode!r}")
        if self.gather_width is not None and self.gather_width < 1:
            raise ValueError(f"gather_width must be >= 1, "
                             f"got {self.gather_width}")

    def resolved_width(self, coding: CodingConfig) -> int:
        w = self.gather_width or coding.decode_quorum
        return min(w, coding.num_workers)


def worker_axis_size(wshard: Optional[WorkerShardConfig]) -> int:
    """Ranks of the active worker group (1 off any group: the one-rank
    path)."""
    group = partitioning.active_group()
    if wshard is None or group is None:
        return 1
    return group.size


def validate_layout(coding: CodingConfig, wshard: WorkerShardConfig) -> int:
    """Check the worker-major layout is shardable; returns the axis size."""
    w = worker_axis_size(wshard)
    if coding.num_workers % w != 0:
        raise ValueError(
            f"coded pool of {coding.num_workers} workers cannot shard "
            f"over a {w}-way {wshard.axis!r} group (need divisibility "
            f"so each rank owns whole streams)")
    return w


def rank_workers(coding: CodingConfig,
                 wshard: WorkerShardConfig) -> Tuple[int, int]:
    """(first worker, workers) of this rank's block of the worker-major
    streams: all N+1 on the one-rank path.  The worker group's rank is
    the mesh's "worker" coordinate on any mesh (its ranks differ in that
    coordinate only, listed in its order), a pod or data axis included;
    on those axes a rank holds a sub-block of this block
    (``serving.coded_serving``)."""
    w = validate_layout(coding, wshard)
    nl = coding.num_workers // w
    return (partitioning.active_group().rank * nl if w > 1 else 0), nl


def gather_workers(x: torch.Tensor, wshard: WorkerShardConfig
                   ) -> torch.Tensor:
    """Every rank's rows of ``x`` (leading axis = this rank's workers)
    concatenated in worker order; ``x`` itself on the one-rank path."""
    if worker_axis_size(wshard) == 1:
        return x
    return partitioning.active_group().all_gather(x, 0)


def _survivor_slots(avail: torch.Tensor, width: int):
    """Compacted slot assignment for the survivor gather.

    avail: (N+1,) 0/1 availability.  Returns (slots (N+1,) int64, the
    compacted destination of each stream, ``width`` = dropped; idx
    (width,) int64, the source stream of each slot, 0 for empty slots;
    slot_valid (width,) float32, 1.0 while a slot holds a survivor).
    Compaction preserves stream order, so survivor ranks, the only thing
    the survivor weights' signs depend on, are unchanged.
    """
    u = (avail > 0).to(torch.int64)
    pos = torch.cumsum(u, 0) - 1
    slots = torch.where((u > 0) & (pos < width), pos,
                        torch.full_like(pos, width))
    idx = torch.zeros((width + 1,), dtype=torch.int64, device=avail.device)
    idx = idx.scatter(0, slots, torch.arange(u.shape[0],
                                             device=avail.device))[:width]
    nsurv = torch.clamp(u.sum(), max=width)
    slot_valid = (torch.arange(width, device=avail.device)
                  < nsurv).to(torch.float32)
    return slots, idx, slot_valid


def _decode_rows(grouped: torch.Tensor, masks: torch.Tensor,
                 alphas: torch.Tensor, betas: torch.Tensor,
                 row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(G, S, V') coded block -> (G*K, V') decoded real-query rows."""
    dec = ops.fused_group_decode(grouped, masks, alphas, betas)
    dec = dec.reshape(-1, dec.shape[-1])
    if row_mask is not None:
        dec = dec * row_mask[:, None].to(dec.dtype)
    return dec


def _sample_vocab_sharded(logits: torch.Tensor, config: SampleConfig,
                          generator: Optional[torch.Generator],
                          group: WorkerGroup, vloc: int) -> torch.Tensor:
    """``sampling.sample_tokens`` over a vocabulary-sharded (rows, V/W)
    block, bit-identical to it on the gathered rows: greedy breaks ties
    to the lowest global index (argmax over the rank-ordered candidate
    table), and the merged per-rank top-k keeps the full top-k in its
    order (a global top-k element is in its rank's local top-k), so the
    one draw from ``generator`` sees the same candidates in the same
    order.  Ties go to the lower global index, as ``lax.top_k``'s: each
    rank selects in that order, and the stable merge over the rank-major
    candidate table keeps equal values in table order, which is global
    index order (rank r holds the r-th slice of the vocabulary)."""
    offset = group.rank * vloc
    if config.top_k <= 1:
        li = torch.argmax(logits, dim=-1)
        lv = torch.gather(logits, -1, li[:, None])[:, 0]
        gv = group.all_gather(lv[None], 0)                  # (W, rows)
        gi = group.all_gather((li + offset).to(torch.int32)[None], 0)
        best = torch.argmax(gv, dim=0)                      # ties -> low rank
        return torch.gather(gi, 0, best[None])[0]
    if generator is None:
        raise ValueError("top_k > 1 sampling needs a generator")
    kk = config.top_k
    lv, li = top_k_stable(logits.to(torch.float32), kk)
    gv = group.all_gather(lv[None], 0)                      # (W, rows, kk)
    gi = group.all_gather((li + offset).to(torch.int32)[None], 0)
    rows = logits.shape[0]
    gv = gv.movedim(0, 1).reshape(rows, group.size * kk)
    gi = gi.movedim(0, 1).reshape(rows, group.size * kk)
    vals, sel = top_k_stable(gv, kk)
    idx = torch.gather(gi, -1, sel)
    probs = torch.softmax(vals / config.temperature, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(idx, -1, choice)[:, 0].to(torch.int32)


def survivor_decode_tail(coding: CodingConfig, block: torch.Tensor,
                         masks: torch.Tensor, avail: torch.Tensor,
                         wshard: WorkerShardConfig, *,
                         row_mask: Optional[torch.Tensor] = None,
                         sample: Optional[SampleConfig] = None,
                         generator: Optional[torch.Generator] = None):
    """Decode tail over worker-major coded logits.

    block: this rank's (nl, G, V) worker-major coded logits (all
    (N+1, G, V) on the one-rank path); masks: (G, N+1) float decode
    masks (availability with the locator's exclusions composed in);
    avail: (N+1,) float availability, which defines the shared survivor
    slots; row_mask: optional (G*K,) live-row mask applied to decoded
    rows before sampling.  masks and avail are the same on every rank.
    Returns (G*K,) sampled int32 tokens with ``sample``, else (G*K, V)
    decoded logits, the same on every rank.
    """
    w = validate_layout(coding, wshard)
    if block.shape[0] * w != coding.num_workers:
        raise ValueError(f"a rank of {w} holds {coding.num_workers // w} "
                         f"workers' streams, got {block.shape[0]}")
    group = partitioning.active_group() if w > 1 else None
    return _decode_tail(coding, block, masks, avail, wshard, group,
                        row_mask, sample, generator)


def _decode_tail(coding: CodingConfig, block: torch.Tensor,
                 masks: torch.Tensor, avail: torch.Tensor,
                 wshard: WorkerShardConfig, group: Optional[WorkerGroup],
                 row_mask: Optional[torch.Tensor],
                 sample: Optional[SampleConfig],
                 generator: Optional[torch.Generator]):
    """``survivor_decode_tail`` over ``group``'s collectives, or with
    ``group=None`` the one-rank path's same math without them."""
    width = wshard.resolved_width(coding)
    alphas, betas = berrut.nodes(coding, block.device)
    mf = masks.to(torch.float32)

    if wshard.mode == "replicated":
        if group is None:
            dec = _decode_rows(block.transpose(0, 1), mf, alphas, betas,
                               row_mask)
            return dec if sample is None else sample_tokens(dec, sample,
                                                            generator)
        return _replicated_tail(block, mf, alphas, betas, group, row_mask,
                                sample, generator)

    slots, idx, slot_valid = _survivor_slots(avail, width)
    masks_c = mf[:, idx] * slot_valid[None, :]
    betas_c = betas[idx]
    if group is None:
        grouped = block.index_select(0, idx).transpose(0, 1)  # (G, width, V)
        dec = _decode_rows(grouped, masks_c, alphas, betas_c, row_mask)
        return dec if sample is None else sample_tokens(dec, sample,
                                                        generator)
    return _survivor_tail(block, masks_c, betas_c, slots, alphas, group,
                          width, row_mask, sample, generator)


def _survivor_tail(block, masks_c, betas_c, slots, alphas,
                   group: WorkerGroup, width: int, row_mask, sample,
                   generator):
    """Survivor gather over the group: compact-scatter, reduce-scatter
    over the vocabulary, vocabulary-sharded fused decode and sampling."""
    w = group.size
    nl, g, v = block.shape
    # the reduce-scatter needs the vocabulary divisible by W, and the
    # merged top-k needs each rank to hold >= top_k entries; otherwise
    # all-reduce the compacted buffer (still less than the all-gather
    # when width < (N+1)/2)
    scatter_v = v % w == 0 and (sample is None or sample.top_k <= v // w)
    local_slots = slots[group.rank * nl:(group.rank + 1) * nl]
    buf = block.new_zeros((width + 1, g, v))
    buf[local_slots] = block                   # non-survivors: spill row
    buf = buf[:width]
    part = group.reduce_scatter(buf) if scatter_v else group.all_reduce(buf)
    dec = _decode_rows(part.transpose(0, 1), masks_c, alphas, betas_c,
                       row_mask)
    if sample is None:
        return group.all_gather(dec, 1) if scatter_v else dec
    if not scatter_v:
        return sample_tokens(dec, sample, generator)
    return _sample_vocab_sharded(dec, sample, generator, group, v // w)


def _replicated_tail(block, masks, alphas, betas, group: WorkerGroup,
                     row_mask, sample, generator):
    """The baseline: all-gather every coded stream, decode replicated."""
    full = group.all_gather(block, 0)                        # (N+1, G, V)
    dec = _decode_rows(full.transpose(0, 1), masks, alphas, betas, row_mask)
    return dec if sample is None else sample_tokens(dec, sample, generator)
