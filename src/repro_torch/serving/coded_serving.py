"""Coded serving steps, batch and slot-pool paths (port of
``repro.serving.coded_serving``).

Every coded stream owns its own cache (KV, or the SSM conv window and
state), so stragglers and Byzantine workers can be masked at any decode
step without recomputation.  Shapes: G query groups x K real queries;
N+1 coded streams per group, laid out group-major (stream
``g*(N+1) + n``) by default.  With ``wshard`` (a
``launch.worker_mesh.WorkerShardConfig``) they are laid out worker-major
(stream ``n*G + g``) and each rank of the active worker group holds,
encodes, runs and caches only its own contiguous block of them; the
round's tail is the survivor-only decode of ``launch.worker_mesh``.
On an active mesh (``models.partitioning.mesh_context``) the steps pad
the group-major streams to the product of its worker, pod and data axes
(``num_padded_streams``: padding streams repeat stream 0), and a rank
runs and caches its block of them over those axes in the reference's
"batch" order, worker outermost (``partitioning.batch_block``); the
ranks of the "pod" and "data" axes that share a worker coordinate (the
mesh's batch group) all-gather their blocks before the locate-and-decode
tail, which drops the padding first (``_whole_streams``).  Worker-major
streams are never padded: a rank keeps its pod/data sub-block of its
worker's streams, and the gather gives back the worker's whole block,
on which the survivor tail runs over "worker".  The "model" axis splits
each stream's heads, MLP and vocabulary inside the model (``models``).
Off any mesh every rank runs the whole round, unpadded.

Re-planning stays data, not Python branches: the straggler mask, the
operating point's ``live_mask`` and ``locate_quorum`` are tensors or
numbers fed to one program, as in the reference.  The reference draws
Byzantine noise with ``jax.random`` inside the step; here the caller
passes the noise tensor in, so tests can hand both the same draw.

The slot pool (DESIGN.md §10) keeps ``pool_groups * (N+1)`` coded-stream
caches for the whole serving run (on a mesh a rank's block of them,
padded as the batch steps pad): a group slot is live or free, never a
different shape.  The reference donates the pool state to its jitted
steps; here the steps write the pool caches in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import berrut
from repro_torch.core.berrut import CodingConfig
from repro_torch.core.error_locator import gather_vote_values, locate_groups
from repro_torch.kernels import ops
from repro_torch.launch import worker_mesh
from repro_torch.launch.worker_mesh import WorkerShardConfig
from repro_torch.models import layers, partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, embed_inputs, init_caches,
                                      prefill)
from repro_torch.serving.sampling import SampleConfig, sample_tokens


@dataclasses.dataclass(frozen=True)
class CodedServingState:
    """Carried between serving steps.  The caches are written in place by
    the next step (where the reference's executors donate them), so a
    state is consumed by the step it is passed to."""

    caches: list                   # per-run coded-stream caches
    pos: int                       # next cache position to write


def num_padded_streams(coding: CodingConfig, groups: int) -> int:
    """Coded streams padded to the active mesh's batch-axes product
    (``partitioning.padded_batch``): every rank holds an even share."""
    return partitioning.padded_batch(groups * coding.num_workers)


def _check_batch_axes(wshard: Optional[WorkerShardConfig]) -> None:
    """Raise for a mesh this step does not serve on: a "worker" axis
    above 1 without ``wshard`` (it splits worker-major streams only).
    Every family serves on the "pod" and "data" axes, the MoE layer with
    the whole batch's routing (``models.moe.moe_block``)."""
    if partitioning.axis_size("worker") > 1 and wshard is None:
        raise ValueError("a worker axis above 1 shards worker-major "
                         "streams: pass wshard")


def _sub_block(coding: CodingConfig, groups: int) -> tuple:
    """(start, length) of this rank's pod/data sub-block of its worker's
    ``nl * groups`` worker-major streams.  Worker-major streams cannot be
    padded (the reference's error), so the batch axes must divide them."""
    n = groups * coding.num_workers
    if num_padded_streams(coding, groups) != n:
        raise ValueError(
            "worker-major coded streams cannot be padded: "
            f"{n} streams vs mesh batch product "
            f"{num_padded_streams(coding, groups)} (make N+1 divisible "
            "by the worker axis)")
    start, length = partitioning.batch_block(n)
    nl = n // partitioning.axis_size("worker")
    return start % nl, length


def _code_streams(coding: CodingConfig, x: torch.Tensor,
                  wshard: Optional[WorkerShardConfig] = None
                  ) -> torch.Tensor:
    """(G, K, ...) -> this rank's coded streams through the Berrut encode
    contraction (kernel-dispatched): group-major (stream ``g*(N+1) +
    n``), padded to ``num_padded_streams`` with repeats of stream 0, and
    on a mesh the rank's block of them (``partitioning.batch_block``).

    With ``wshard`` the rows are worker-major, ``n*G + g``, and a rank of
    the worker group encodes only its workers' streams: its rows of the
    encode matrix through ``ops.berrut_encode_dispatch`` give exactly its
    contiguous block of the full output, by the same arithmetic.  On
    "pod" and "data" axes it keeps its sub-block of them (``_sub_block``).
    Worker-major streams are never padded: the worker axis divides N+1
    (``worker_mesh.validate_layout``)."""
    g = x.shape[0]
    real = g * coding.num_workers
    # rounded to x's dtype first, as the reference rounds its weights
    w = berrut.encode_matrix(coding, device=x.device).to(x.dtype)
    flat = x.reshape(g, coding.k, -1)
    if wshard is not None:
        lo, nl = worker_mesh.rank_workers(coding, wshard)
        start, length = _sub_block(coding, g)
        coded = ops.berrut_encode_dispatch(w[lo:lo + nl], flat)  # (nl*G, F)
        coded = coded.reshape(nl * g, *x.shape[2:])
        return coded if length == nl * g else coded[start:start + length]
    coded = ops.berrut_apply(w, flat)                     # (G, N+1, F)
    coded = coded.reshape(real, *x.shape[2:])
    pad = num_padded_streams(coding, g) - real
    if pad:
        coded = torch.cat([coded, coded[:1].expand(pad, *coded.shape[1:])])
    start, length = partitioning.batch_block(coded.shape[0])
    return coded if length == coded.shape[0] else \
        coded[start:start + length]


def _whole_streams(coding: CodingConfig, coded_logits: torch.Tensor,
                   groups: int,
                   wshard: Optional[WorkerShardConfig] = None
                   ) -> torch.Tensor:
    """The round's coded logits from this rank's block: the blocks of
    the batch group ("pod" and "data") all-gathered in block order; then
    group-major the whole (G*(N+1), V) with the padding streams dropped,
    or with ``wshard`` this rank's worker's whole (nl*G, V) block."""
    group = partitioning.batch_group()
    if group is not None:
        coded_logits = group.all_gather(coded_logits, 0)
    if wshard is not None:
        return coded_logits
    return coded_logits[: groups * coding.num_workers]


def locate(coding: CodingConfig, coded_logits: torch.Tensor,
           avail: torch.Tensor, locate_quorum=None,
           wshard: Optional[WorkerShardConfig] = None):
    """Vote-gated Algorithm 2 per group over the round's coded logits.

    The vote columns are gathered from the raw block before the float32
    upcast.  ``locate_quorum`` (an int or a 0-dim tensor) suppresses the
    verdicts of a round with fewer available streams; ``None`` keeps them
    unconditional.  coded_logits: (G*(N+1), V), or with ``wshard`` this
    rank's (nl*G, V) worker-major streams, whose (nl, G, C_vote) vote
    slice is all-gathered so that every rank locates on all N+1 workers.
    Returns (per-group decode masks (G, N+1), located (G, N+1) bool,
    votes (G, N+1) int32), the same on every rank.
    """
    n1 = coding.num_workers
    nl = (n1 if wshard is None
          else worker_mesh.rank_workers(coding, wshard)[1])
    g = coded_logits.shape[0] // nl
    if coding.e == 0:
        zeros = torch.zeros((g, n1), dtype=torch.int32,
                            device=coded_logits.device)
        return avail.expand(g, n1), zeros.bool(), zeros
    if wshard is not None:
        # gather the tiny vote slice, then transpose: only (N+1, G,
        # C_vote) values ever move
        vals = worker_mesh.gather_workers(gather_vote_values(
            coded_logits.reshape(nl, g, -1), coding.c_vote),
            wshard).transpose(0, 1)
    else:
        vals = gather_vote_values(coded_logits.reshape(g, n1, -1),
                                  coding.c_vote)
    _, betas = berrut.nodes(coding, coded_logits.device)
    located, votes = locate_groups(betas, vals, avail, k=coding.k,
                                   e=coding.e)
    if locate_quorum is not None:
        located = located & (avail.sum() >= locate_quorum)
    masks = avail[None, :] * (1.0 - located.to(avail.dtype))
    return masks, located, votes


def _corrupt_logits(coding: CodingConfig, coded_logits: torch.Tensor,
                    byz_mask: torch.Tensor, noise: torch.Tensor,
                    sigma: float,
                    wshard: Optional[WorkerShardConfig] = None
                    ) -> torch.Tensor:
    """Byzantine workers add ``sigma * noise`` to their coded logits
    (paper §4.2).  noise: (G, N+1, V), or (G, 1, V) when every compromised
    worker of a group tells the same lie (collusion).  With ``wshard`` the
    same noise is swapped to worker-major and sliced to this rank's
    streams, so stream (n, g) gets the same value in either layout."""
    n1 = coding.num_workers
    v = coded_logits.shape[-1]
    if wshard is None:
        g = coded_logits.shape[0] // n1
        per_stream = byz_mask.repeat(g)
        noise = noise.expand(g, n1, v).reshape(g * n1, v)
    else:
        lo, nl = worker_mesh.rank_workers(coding, wshard)
        g = coded_logits.shape[0] // nl
        per_stream = byz_mask[lo:lo + nl].repeat_interleave(g)
        noise = noise.expand(g, n1, v).transpose(0, 1)[lo:lo + nl]
        noise = noise.reshape(nl * g, v)
    return coded_logits + sigma * per_stream[:, None] * noise


def _compose_live(straggler_mask: Optional[torch.Tensor],
                  live_mask: Optional[torch.Tensor]
                  ) -> Optional[torch.Tensor]:
    """Compose the operating point's per-stream ``live_mask`` into the
    round's straggler mask: a narrower (N, E) masks off the trailing
    coded streams exactly like stragglers, so one max-width program
    serves every operating point."""
    if live_mask is None:
        return straggler_mask
    if straggler_mask is None:
        return live_mask
    return straggler_mask * live_mask


def _finish_round(coding: CodingConfig, coded_logits: torch.Tensor,
                  straggler_mask: Optional[torch.Tensor], with_report: bool,
                  locate_quorum=None):
    """Shared tail of every coded round: locate -> exclude -> one fused
    decode pass (per-group survivor-weight matrices built in the kernel
    from the locator's masks)."""
    dev = coded_logits.device
    avail = (straggler_mask if straggler_mask is not None
             else torch.ones((coding.num_workers,), dtype=torch.float32,
                             device=dev))
    v = coded_logits.shape[-1]
    g = coded_logits.shape[0] // coding.num_workers
    masks, located, votes = locate(coding, coded_logits, avail,
                                   locate_quorum=locate_quorum)
    grouped = coded_logits.reshape(g, coding.num_workers, v)
    logits = ops.fused_group_decode(grouped, masks.to(torch.float32),
                                    *berrut.nodes(coding, dev))
    logits = logits.reshape(g * coding.k, v)
    return logits, ((located, votes) if with_report else None)


def _finish_round_wm(coding: CodingConfig, coded_logits: torch.Tensor,
                     straggler_mask: Optional[torch.Tensor],
                     with_report: bool, wshard: WorkerShardConfig,
                     sample: Optional[SampleConfig],
                     generator: Optional[torch.Generator],
                     row_mask: Optional[torch.Tensor] = None,
                     locate_quorum=None):
    """Worker-sharded round tail (DESIGN.md §13): locate on the gathered
    vote slice as ``_finish_round`` does, then the survivor-only decode
    of ``launch.worker_mesh.survivor_decode_tail``, which samples on the
    vocabulary shard.  coded_logits: this rank's (nl*G, V) worker-major
    streams.  Returns (out, report) where ``out`` is (G*K,) token ids
    with ``sample``, else (G*K, V) logits."""
    dev = coded_logits.device
    avail = (straggler_mask if straggler_mask is not None
             else torch.ones((coding.num_workers,), dtype=torch.float32,
                             device=dev))
    masks, located, votes = locate(coding, coded_logits, avail,
                                   locate_quorum=locate_quorum,
                                   wshard=wshard)
    nl = worker_mesh.rank_workers(coding, wshard)[1]
    block = coded_logits.reshape(nl, -1, coded_logits.shape[-1])
    out = worker_mesh.survivor_decode_tail(
        coding, block, masks, avail, wshard, row_mask=row_mask,
        sample=sample, generator=generator)
    return out, ((located, votes) if with_report else None)


def _maybe_sample(logits: torch.Tensor, sample: Optional[SampleConfig],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    if sample is None:
        return logits
    return sample_tokens(logits, sample, generator)


def _round_tail(coding: CodingConfig, coded_logits: torch.Tensor,
                group_mask: Optional[torch.Tensor], straggler_mask,
                byz_mask, byz_noise, byz_sigma: float, with_report: bool,
                sample: Optional[SampleConfig],
                generator: Optional[torch.Generator], locate_quorum,
                wshard: Optional[WorkerShardConfig]):
    """A round after the model: the attack, then the group-major tail and
    sampling or the worker-sharded tail (with a pool's ``group_mask``,
    ``_finish_pool_round``).  Returns (logits or token ids, report)."""
    if byz_mask is not None and byz_noise is not None:
        coded_logits = _corrupt_logits(coding, coded_logits, byz_mask,
                                       byz_noise, byz_sigma, wshard)
    if group_mask is not None:
        return _finish_pool_round(coding, coded_logits, group_mask,
                                  straggler_mask, with_report,
                                  locate_quorum=locate_quorum, wshard=wshard,
                                  sample=sample, generator=generator)
    if wshard is not None:
        return _finish_round_wm(coding, coded_logits, straggler_mask,
                                with_report, wshard, sample, generator,
                                locate_quorum=locate_quorum)
    logits, report = _finish_round(coding, coded_logits, straggler_mask,
                                   with_report, locate_quorum=locate_quorum)
    return _maybe_sample(logits, sample, generator), report


def coded_prefill(cfg: ModelConfig, coding: CodingConfig, params: dict,
                  inputs: dict, max_len: int,
                  straggler_mask: Optional[torch.Tensor] = None,
                  cache_dtype: Optional[torch.dtype] = None,
                  byz_mask: Optional[torch.Tensor] = None,
                  byz_noise: Optional[torch.Tensor] = None,
                  byz_sigma: float = 10.0,
                  with_report: bool = False,
                  sample: Optional[SampleConfig] = None,
                  generator: Optional[torch.Generator] = None,
                  live_mask: Optional[torch.Tensor] = None,
                  locate_quorum=None,
                  wshard: Optional[WorkerShardConfig] = None):
    """Prefill G*K real prompts as G*(N+1) coded streams.

    inputs: a modality dict with G*K rows (``{"tokens": (G*K, S)}``,
    vlm ``{"patches", "tokens"}``, audio ``{"frames"}``) or
    ``{"embeddings": (G*K, S, d)}``; the N+1 coded streams of a group
    encode its whole residual stream (a vlm's patches, then its text),
    and the state's ``pos`` is its length.
    ``cache_dtype``: the coded caches' dtype (default the coded
    streams').
    Byzantine workers (``byz_mask``, (N+1,)) add ``byz_sigma * byz_noise``
    to their logits.  Returns (decoded last-token logits (G*K, V), or
    with ``sample`` the (G*K,) int32 token ids, and the serving state);
    with ``with_report`` also the locator's (located, votes).  With
    ``wshard`` the state holds this rank's worker-major streams only; on
    "pod" and "data" axes a rank's state holds its block of the streams
    (``_code_streams``).
    """
    _check_batch_axes(wshard)
    straggler_mask = _compose_live(straggler_mask, live_mask)
    x = embed_inputs(cfg, params, inputs)                 # (G*K, S, d)
    gk, s, d = x.shape
    g = gk // coding.k
    coded = _code_streams(coding, x.reshape(g, coding.k, s, d), wshard)
    caches = init_caches(cfg, coded.shape[0], max_len,
                         cache_dtype or coded.dtype, coded.device)
    coded_logits, caches = prefill(cfg, params, {"embeddings": coded},
                                   caches)
    coded_logits = _whole_streams(coding, coded_logits, g, wshard)
    out, report = _round_tail(coding, coded_logits, None, straggler_mask,
                              byz_mask, byz_noise, byz_sigma, with_report,
                              sample, generator, locate_quorum, wshard)
    state = CodedServingState(caches=caches, pos=s)
    if with_report:
        return out, state, report
    return out, state


def coded_decode_step(cfg: ModelConfig, coding: CodingConfig, params: dict,
                      state: CodedServingState, tokens: torch.Tensor,
                      straggler_mask: Optional[torch.Tensor] = None,
                      byz_mask: Optional[torch.Tensor] = None,
                      byz_noise: Optional[torch.Tensor] = None,
                      byz_sigma: float = 10.0,
                      with_report: bool = False,
                      sample: Optional[SampleConfig] = None,
                      generator: Optional[torch.Generator] = None,
                      live_mask: Optional[torch.Tensor] = None,
                      locate_quorum=None,
                      wshard: Optional[WorkerShardConfig] = None):
    """One coded decode step.

    tokens: (G*K, 1) — the sampled next token of each real stream.  The K
    token embeddings of each group are Berrut-encoded into N+1 coded
    embeddings appended to the coded caches (in place; ``state`` is
    consumed).  Returns (decoded logits (G*K, V), or sampled (G*K,) ids
    with ``sample``, and the new state); with ``with_report`` also the
    locator's (located, votes).
    """
    _check_batch_axes(wshard)
    straggler_mask = _compose_live(straggler_mask, live_mask)
    x = layers.embed_tokens(cfg, params["embeddings"], tokens)  # (G*K,1,d)
    gk, _, d = x.shape
    g = gk // coding.k
    coded = _code_streams(coding, x.reshape(g, coding.k, 1, d), wshard)
    coded_logits, caches = decode_step(cfg, params, state.caches,
                                       {"embeddings": coded}, state.pos)
    coded_logits = _whole_streams(coding, coded_logits, g, wshard)
    out, report = _round_tail(coding, coded_logits, None, straggler_mask,
                              byz_mask, byz_noise, byz_sigma, with_report,
                              sample, generator, locate_quorum, wshard)
    new_state = CodedServingState(caches=caches, pos=state.pos + 1)
    if with_report:
        return out, new_state, report
    return out, new_state


# --------------------------------------------------------- slot pool (§10)


@dataclasses.dataclass(frozen=True)
class CodedPoolState:
    """Persistent slot-pool serving state.  ``caches`` hold the coded
    streams of every slot and are written in place by the next step;
    ``pos`` is the (pool_groups,) int32 next cache position of each group
    slot, on the caches' device (a group's N+1 streams advance in
    lockstep)."""

    caches: list                   # pool-wide coded-stream caches
    pos: torch.Tensor              # (pool_groups,) int32


def pool_streams(coding: CodingConfig, pool_groups: int,
                 wshard: Optional[WorkerShardConfig] = None) -> int:
    """Coded streams of the pool this rank holds: all P*(N+1), or with
    ``wshard`` its workers' P*nl; on "pod" and "data" axes its block of
    those, the group-major ones padded first (``num_padded_streams``)."""
    if wshard is not None:
        return _sub_block(coding, pool_groups)[1]
    return partitioning.batch_block(
        num_padded_streams(coding, pool_groups))[1]


def init_pool_state(cfg: ModelConfig, coding: CodingConfig,
                    pool_groups: int, max_len: int, device,
                    cache_dtype=None,
                    wshard: Optional[WorkerShardConfig] = None
                    ) -> CodedPoolState:
    """Allocate the fixed slot pool: ``pool_streams`` zeroed coded-stream
    caches on ``device`` and zeroed slot positions."""
    _check_batch_axes(wshard)
    if pool_groups < 1:
        raise ValueError(f"need pool_groups >= 1, got {pool_groups}")
    dtype = cache_dtype or getattr(torch, cfg.param_dtype)
    caches = init_caches(cfg, pool_streams(coding, pool_groups, wshard),
                         max_len, dtype, device)
    return CodedPoolState(caches=caches, pos=torch.zeros(
        (pool_groups,), dtype=torch.int32, device=device))


def _per_stream(coding: CodingConfig, per_group: torch.Tensor,
                wshard: Optional[WorkerShardConfig],
                pad: torch.Tensor) -> torch.Tensor:
    """(P,) per-slot values -> this rank's per-stream values: group-major
    repeated over each slot's N+1 streams, then the padding streams
    (``pad``, one value), then the rank's block; with ``wshard`` tiled
    over the rank's nl workers, then its pod/data sub-block."""
    p = per_group.shape[0]
    if wshard is not None:
        start, length = _sub_block(coding, p)
        per = per_group.repeat(worker_mesh.rank_workers(coding, wshard)[1])
        return per[start:start + length]
    per = per_group.repeat_interleave(coding.num_workers)
    padded = num_padded_streams(coding, p)
    if padded > per.shape[0]:
        per = torch.cat([per, pad.expand(padded - per.shape[0])])
    start, length = partitioning.batch_block(padded)
    return per[start:start + length]


def _stream_mask(coding: CodingConfig, group_mask: torch.Tensor,
                 wshard: Optional[WorkerShardConfig] = None
                 ) -> torch.Tensor:
    """(P,) group-slot mask -> this rank's coded-stream mask
    (``_per_stream``).  Padding streams are always 0: they repeat stream
    0's content but must never overwrite a live slot's cache."""
    return _per_stream(coding, group_mask, wshard,
                       group_mask.new_zeros((1,)))


def _padding_dead(coding: CodingConfig, groups: int,
                  wshard: Optional[WorkerShardConfig], device
                  ) -> Optional[torch.Tensor]:
    """This rank's (streams,) live mask with only its padding streams
    dead, or None where it holds none (decided on the host)."""
    real = groups * coding.num_workers
    padded = num_padded_streams(coding, groups)
    start, length = partitioning.batch_block(padded)
    if wshard is not None or start + length <= real:
        return None
    return torch.arange(start, start + length, device=device) < real


def _merge_caches(pool: list, fresh: list, streams: torch.Tensor) -> None:
    """Copy the ``streams`` (indices on the stream axis, axis 1 of every
    (layers, streams, ...) cache leaf, local to this rank's block) of
    ``fresh`` into ``pool``, in place; every other stream of the pool is
    untouched."""
    for p, f in zip(pool, fresh):
        for name in p:
            p[name][:, streams] = f[name][:, streams]


def _finish_pool_round(coding: CodingConfig, coded_logits: torch.Tensor,
                       group_mask: torch.Tensor,
                       straggler_mask: Optional[torch.Tensor],
                       with_report: bool, locate_quorum=None,
                       wshard: Optional[WorkerShardConfig] = None,
                       sample: Optional[SampleConfig] = None,
                       generator: Optional[torch.Generator] = None):
    """``_finish_round`` with the active-slot mask composed in: free
    slots' verdicts and votes are zeroed (their garbage logits must not
    feed reputation) and so are their decoded rows.  Returns (logits, or
    token ids sampled from them with ``sample``, report); with ``wshard``
    the rows are zeroed inside the worker-sharded tail, before its
    on-shard sampling."""
    live = group_mask > 0                                  # (P,)
    per_query = group_mask.repeat_interleave(coding.k)     # (P*K,)
    if wshard is not None:
        out, (located, votes) = _finish_round_wm(
            coding, coded_logits, straggler_mask, True, wshard, sample,
            generator, row_mask=per_query, locate_quorum=locate_quorum)
    else:
        logits, (located, votes) = _finish_round(
            coding, coded_logits, straggler_mask, with_report=True,
            locate_quorum=locate_quorum)
        logits = logits * per_query[:, None].to(logits.dtype)
        out = _maybe_sample(logits, sample, generator)
    located = located & live[:, None]
    votes = votes * live[:, None].to(votes.dtype)
    return out, ((located, votes) if with_report else None)


def coded_pool_prefill(cfg: ModelConfig, coding: CodingConfig, params: dict,
                       state: CodedPoolState, inputs: dict, admit_mask,
                       fresh: list,
                       straggler_mask: Optional[torch.Tensor] = None,
                       byz_mask: Optional[torch.Tensor] = None,
                       byz_noise: Optional[torch.Tensor] = None,
                       byz_sigma: float = 10.0,
                       with_report: bool = False,
                       sample: Optional[SampleConfig] = None,
                       generator: Optional[torch.Generator] = None,
                       live_mask: Optional[torch.Tensor] = None,
                       locate_quorum=None,
                       wshard: Optional[WorkerShardConfig] = None):
    """Prefill admitted group slots into the persistent pool.

    inputs: a modality dict of (P*K, ...) rows (``{"tokens": (P*K, S)}``,
    vlm ``{"patches", "tokens"}``, audio ``{"frames"}``) or
    ``{"embeddings": ...}``, the pool-wide prompt buffer (rows of slots
    not admitted carry stale prompts).
    ``admit_mask``: (P,) 0/1 host array (numpy or a CPU tensor) of the
    slots admitted this round.  The whole pool prefills, as in the
    reference: at E > 0 the locator pools votes across every row of the
    round.  Only the admitted streams' caches are copied into the pool
    (in place; ``state`` is consumed).  ``fresh`` is scratch caches of the
    pool's shape (``init_caches``), zeroed here and reused across calls.
    Returns (decoded last-token logits (P*K, V) with rows of slots
    not admitted zeroed, or with ``sample`` their (P*K,) int32 token
    ids, and the new state); with ``with_report`` also the admit-masked
    (located, votes).  With ``wshard`` the pool and ``fresh`` hold this
    rank's worker-major streams only (``pool_streams``).
    """
    _check_batch_axes(wshard)
    straggler_mask = _compose_live(straggler_mask, live_mask)
    x = embed_inputs(cfg, params, inputs)                 # (P*K, S, d)
    gk, s, d = x.shape
    g = gk // coding.k
    admit = torch.as_tensor(admit_mask, dtype=torch.float32)
    if admit.device.type != "cpu":
        raise ValueError("admit_mask is host data (numpy or a CPU tensor)")
    streams = torch.nonzero(_stream_mask(coding, admit, wshard) > 0)[:, 0]
    admit = admit.to(x.device)
    coded = _code_streams(coding, x.reshape(g, coding.k, s, d), wshard)
    for cache in fresh:
        for leaf in cache.values():
            leaf.zero_()
    coded_logits, fresh = prefill(cfg, params, {"embeddings": coded}, fresh)
    _merge_caches(state.caches, fresh, streams.to(x.device))
    coded_logits = _whole_streams(coding, coded_logits, g, wshard)
    new_pos = torch.where(admit > 0, s, state.pos).to(torch.int32)
    out, report = _round_tail(
        coding, coded_logits, admit, straggler_mask, byz_mask, byz_noise,
        byz_sigma, with_report, sample, generator, locate_quorum, wshard)
    new_state = CodedPoolState(caches=state.caches, pos=new_pos)
    if with_report:
        return out, new_state, report
    return out, new_state


def coded_pool_decode_step(cfg: ModelConfig, coding: CodingConfig,
                           params: dict, state: CodedPoolState,
                           tokens: torch.Tensor, active_mask,
                           straggler_mask: Optional[torch.Tensor] = None,
                           byz_mask: Optional[torch.Tensor] = None,
                           byz_noise: Optional[torch.Tensor] = None,
                           byz_sigma: float = 10.0,
                           with_report: bool = False,
                           sample: Optional[SampleConfig] = None,
                           generator: Optional[torch.Generator] = None,
                           live_mask: Optional[torch.Tensor] = None,
                           locate_quorum=None,
                           wshard: Optional[WorkerShardConfig] = None):
    """One decode round over the whole pool.

    tokens: (P*K, 1), the next token of every query row (free slots carry
    don't-care tokens).  Every stream steps at its own slot's cache
    position, ``state.pos`` repeated over the slot's N+1 streams and kept
    on the device; only active slots advance.  Returns (decoded logits
    (P*K, V) with inactive rows zeroed, or sampled (P*K,) ids with
    ``sample``, and the new state); with ``with_report`` also the
    active-masked (located, votes).  ``state`` is consumed.
    """
    _check_batch_axes(wshard)
    straggler_mask = _compose_live(straggler_mask, live_mask)
    x = layers.embed_tokens(cfg, params["embeddings"], tokens)  # (P*K,1,d)
    gk, _, d = x.shape
    g = gk // coding.k
    active = torch.as_tensor(active_mask, dtype=torch.float32,
                             device=x.device)
    coded = _code_streams(coding, x.reshape(g, coding.k, 1, d), wshard)
    # each slot's position over its streams (tiled when worker-major);
    # padding streams track stream 0's, as in the reference
    stream_pos = _per_stream(coding, state.pos, wshard, state.pos[:1])
    # With E == 0 the locator never reads the coded block, so a free
    # slot's attention feeds only rows that are zeroed below: the live
    # mask may reach the kernel, which then reads none of its cache.  With
    # E > 0 the vote pool reads every row, so free slots attend over their
    # stale caches exactly as in the reference, and only the padding
    # streams, whose logits are dropped, reach the kernel dead.
    stream_live = (_stream_mask(coding, active, wshard) > 0
                   if coding.e == 0 else _padding_dead(coding, g, wshard,
                                                       x.device))
    coded_logits, caches = decode_step(cfg, params, state.caches,
                                       {"embeddings": coded}, stream_pos,
                                       live=stream_live)
    coded_logits = _whole_streams(coding, coded_logits, g, wshard)
    out, report = _round_tail(
        coding, coded_logits, active, straggler_mask, byz_mask, byz_noise,
        byz_sigma, with_report, sample, generator, locate_quorum, wshard)
    new_pos = state.pos + (active > 0).to(torch.int32)
    new_state = CodedPoolState(caches=caches, pos=new_pos)
    if with_report:
        return out, new_state, report
    return out, new_state
