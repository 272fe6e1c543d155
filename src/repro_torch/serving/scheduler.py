"""Event-driven coded serving scheduler with adaptive wait-for decode
(port of ``repro.serving.scheduler``).

Requests arrive on a Poisson/trace clock into the deadline-flushing
``GroupBatcher``; each dispatched batch samples per-worker completion
times from ``LatencyModel``; the decoder fires the moment the fastest
``wait_for`` coded workers land, deriving the straggler mask from the
event clock (``mask_from_completion_times``).  The loop is written
against the ``RedundancyScheme`` protocol (``core.scheme``): worker-pool
width, wait-for quorum, masks and reputation/quarantine all key off
``scheme.plan``.  An optional speculative path early-decodes at a
latency SLO from whatever workers have landed, then corrects when the
full quorum arrives.

With E > 0 a stateful adversary (``serving.failures``) corrupts the
compromised workers' outputs at completion time, the decode runs the
locate-then-decode pipeline, the adaptive wait-for drops to the locator
quorum K+2E (``decode_quorum``), confirmed detections feed per-worker
reputation and the quarantine policy (``serving.quarantine``), and the
quarantine/churn quorum invariant (``apply_pool_state``, DESIGN.md §12)
keeps every round at that quorum.  ``controller=`` retunes (N, E,
wait_for) between batches (``serving.controller``).

Two executors drive real compute behind the same event loop:

  * ``EngineExecutor``: the ``coded_inference`` path (encode -> predict
    -> mask-decode), decoding bit-identically to ``coded_inference``
    with the scheduler-derived mask;
  * ``serving.executor.CodedLLMExecutor``: the coded prefill / decode
    steps, one coded dispatch a round.

Simulated time is milliseconds on a discrete-event heap; model compute
runs for real when its event fires.  The arrival clocks, seed streams,
ground-truth scoring and ``apply_pool_state`` are numpy and copied as
they are; a seed gives the reference's event trace.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.berrut import CodingConfig
from repro_torch.core.engine import group_queries, mask_from_completion_times
from repro_torch.core.scheme import RedundancyScheme, as_scheme
from repro_torch.serving.batcher import DEFAULT_CLASS, BatchPlan, GroupBatcher
from repro_torch.serving.controller import RedundancyController
from repro_torch.serving.failures import (AdversaryConfig, RoundAttack,
                                          corrupt_coded_preds, make_adversary)
from repro_torch.serving.latency import ChurnModel, LatencyModel, WorkerChurn
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.quarantine import QuarantineConfig, WorkerReputation

# Event kinds; the numeric order breaks timestamp ties: a batch-filling
# arrival dispatches before a flush deadline at the same instant, and a
# speculative decode precedes the full decode it anticipates.
_ARRIVAL, _FLUSH, _SPEC, _ROUND = 0, 1, 2, 3


def poisson_arrivals(n: int, rate_rps: float, seed: int = 0,
                     start_ms: float = 0.0) -> np.ndarray:
    """(n,) Poisson arrival times in ms for an open-loop ``rate_rps``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1e3 / rate_rps, size=n)
    return start_ms + np.cumsum(gaps)


def derive_seed_streams(seed: int) -> Tuple[np.random.RandomState, int]:
    """(worker-latency rng, arrival seed) from one scheduler seed.

    Worker latencies and (fallback) arrivals must be INDEPENDENT
    streams: reusing the config seed for both would correlate arrival
    gaps with worker latencies draw for draw.  Shared by the legacy and
    continuous schedulers so a seed means the same thing in both.
    """
    root = np.random.RandomState(seed)
    rng = np.random.RandomState(root.randint(0, 2 ** 31 - 1))
    return rng, int(root.randint(0, 2 ** 31 - 1))


def resolve_arrivals(n_payloads: int,
                     arrival_ms: Optional[Sequence[float]],
                     rate_rps: Optional[float],
                     arrival_seed: int) -> Sequence[float]:
    """Validate/derive the arrival clock for a serving run."""
    if arrival_ms is None:
        if rate_rps is None:
            raise ValueError("need arrival_ms or rate_rps")
        arrival_ms = poisson_arrivals(n_payloads, rate_rps,
                                      seed=arrival_seed)
    if len(arrival_ms) != n_payloads:
        raise ValueError("arrival_ms/payloads length mismatch")
    return arrival_ms


def round_ground_truth(mask: np.ndarray, attack) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """(dispatched, truly-corrupting-and-dispatched) bool masks for
    scoring one locate round against the adversary's ground truth."""
    dispatched = mask >= 0.5
    corrupt = ((attack.mask >= 0.5) if attack is not None
               else np.zeros_like(dispatched))
    return dispatched, corrupt & dispatched


def apply_pool_state(scheme, wait_target: int, times: np.ndarray,
                     now: float, reputation=None, churn=None
                     ) -> Tuple[int, np.ndarray, bool, int]:
    """Fold churn + quarantine into one round's completion times and
    derive the effective wait-for under the quorum invariant (§12).

    Returns ``(wait, times, degraded, locate_quorum)``.

    The quarantine→quorum hole this closes: quarantine holds (or churn)
    can shrink the dispatchable pool below ``scheme.decode_quorum``, and
    the old clamp ``min(wait_for, active)`` then silently dropped the
    decode below the K+2E locator quorum — the locator stopped running
    exactly when workers were being held for misbehaving.  Now:

      1. if the pool cannot meet the quorum, the longest-held
         quarantined workers are readmitted early
         (``WorkerReputation.release_for_quorum``) before sampling;
      2. if the quorum IS reachable, the round waits for it (never
         silently below — "wait for all active workers");
      3. if even readmission cannot restore it (churn), the round is
         **degraded**: it waits for every active worker and the decode
         forces the locator at the reduced quorum ``K + 2*E_active``
         (``E_active = E - held``: each hold spends locator budget on a
         worker that cannot corrupt this round anyway).

    A ``wait_target`` the caller set explicitly BELOW the quorum (the
    latency-over-robustness operating point, e.g. speculative serving
    experiments) is honored unchanged — the invariant protects against
    the pool shrinking under a quorum-respecting target, not against a
    deliberate override.
    """
    width = len(times)
    quorum = min(scheme.decode_quorum, width)
    if reputation is None and churn is None:
        return wait_target, times, False, quorum
    avail = np.ones((width,), np.float32)
    if churn is not None:
        avail *= churn.alive_mask(now)[:width]
    held = 0
    if reputation is not None:
        active = reputation.active_mask(now)[:width]
        if float((avail * active).sum()) < quorum:
            alive_full = np.zeros((len(reputation.quarantined),),
                                  np.float32)
            alive_full[:width] = avail
            reputation.release_for_quorum(now, quorum, alive=alive_full)
            active = (~reputation.quarantined).astype(np.float32)[:width]
        avail *= active
        held = int(reputation.quarantined.sum())
    active_n = int(avail.sum())
    if active_n == 0:
        # total churn blackout: the round effectively stalls until
        # workers return — dispatch to the sampled pool and flag it
        return wait_target, times, True, quorum
    times = np.where(avail > 0, times, np.inf)
    wait = max(1, min(wait_target, active_n))
    if scheme.has_locator and wait_target >= quorum and wait < quorum:
        wait = min(quorum, active_n)        # all active workers
    degraded = active_n < min(wait_target, quorum)
    locate_quorum = quorum
    if degraded:
        e_active = max(scheme.e - held, 0)
        locate_quorum = min(quorum, scheme.k + 2 * e_active)
    return wait, times, degraded, locate_quorum


def check_gather_bound(executor, wait_for: int) -> None:
    """Re-validate the worker-shard gather width against a (re)tuned
    wait-for (DESIGN.md §13/§15).

    The construction-time guard pins the gather width to the INITIAL
    operating point; once executors re-plan, a controller retune that
    raises wait_for past ``wshard.resolved_width`` would silently
    truncate survivors the round paid latency for.  Both schedulers call
    this on every ``ControlDecision`` — raising beats clamping here,
    because a clamped operating point would silently decode below the
    redundancy the controller believes it provisioned.
    """
    wshard = getattr(executor, "wshard", None)
    coding = getattr(executor, "coding", None)
    if wshard is None or coding is None:
        return
    width = wshard.resolved_width(coding)
    if width < wait_for:
        raise ValueError(
            f"retuned wait_for {wait_for} exceeds the worker-shard gather "
            f"width {width}: survivor-only decode would drop responses "
            f"the round waited for — construct the executor with "
            f"WorkerShardConfig(gather_width={wait_for}) (or cap the "
            f"controller's operating points)")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the serving runtime.

    The redundancy scheme comes from ``scheme`` (any registered
    ``RedundancyScheme``) or, for the pre-protocol API, from ``coding``
    (a bare ``CodingConfig``, normalized to ``BerrutScheme``).  Exactly
    the executor's scheme must be described here; when the executor
    carries its own ``scheme`` attribute that one wins.
    """

    coding: Optional[CodingConfig] = None
    scheme: Optional[RedundancyScheme] = None
    groups_per_batch: int = 1
    flush_deadline_ms: Optional[float] = 2.0   # None: only full batches
    slo_ms: Optional[float] = None             # speculative decode trigger
    seed: int = 0                              # worker-latency stream
    # Adaptive wait-for; None -> scheme.decode_quorum (K with E = 0, the
    # locator quorum K+2E with E > 0 — tighter than the paper's offline
    # 2(K+E), see CodingConfig.decode_quorum).
    wait_for: Optional[int] = None
    adversary: Optional[AdversaryConfig] = None
    quarantine: Optional[QuarantineConfig] = None
    # -- production-traffic realism + closed-loop redundancy (§12) --
    # Adaptive (N, E, wait_for) retuning between batches; requires an
    # executor that can re-plan per batch (EngineExecutor, or
    # CodedLLMExecutor constructed at controller.max_scheme, the masked
    # max-width path).  Per-worker state
    # (reputation, adversary, churn) is sized to the controller's
    # MAXIMUM operating point; narrower batches dispatch to a prefix.
    controller: Optional[RedundancyController] = None
    # Worker churn (leave/rejoin on the event clock); a churned-out
    # worker's results never land, exactly like a quarantine hold.
    churn: Optional[ChurnModel] = None
    # Per-SLO-class flush deadlines (multi-tenant batching; classes
    # never mix in a batch).  Falls back to ``flush_deadline_ms``.
    class_deadlines: Optional[Dict[str, Optional[float]]] = None


@dataclasses.dataclass(frozen=True)
class LocateReport:
    """One locate round's verdicts (host-side copies of the locate
    pipeline's outputs, per group)."""

    located: np.ndarray               # (G, N+1) bool, vote-gated
    votes: np.ndarray                 # (G, N+1) int32
    masks: np.ndarray                 # (G, N+1) decode masks actually used

    @property
    def detected(self) -> np.ndarray:
        """(N+1,) bool — located in at least one group this round."""
        return self.located.any(axis=0)


@dataclasses.dataclass
class InflightBatch:
    """One dispatched coded batch, tracked from dispatch to decode."""

    bid: int
    plan: BatchPlan
    queries: Any                       # stacked payloads handed to executor
    dispatch_plan: Any = None          # scheme.plan(...) for this batch
    scheme: Any = None                 # operating point at dispatch time
    wait_target: int = 0               # intended wait-for at dispatch time
    handle: Any = None                 # executor state
    dispatch_ms: float = 0.0
    round_masks: List[np.ndarray] = dataclasses.field(default_factory=list)
    round_quorums: List[int] = dataclasses.field(default_factory=list)
    round_waits: List[float] = dataclasses.field(default_factory=list)
    round_attacks: List[Optional[RoundAttack]] = dataclasses.field(
        default_factory=list)
    round_reports: List[Optional[LocateReport]] = dataclasses.field(
        default_factory=list)
    worker_times: List[np.ndarray] = dataclasses.field(default_factory=list)
    outputs: Any = None
    complete_ms: float = 0.0
    spec_ms: Optional[float] = None
    spec_mask: Optional[np.ndarray] = None
    spec_outputs: Any = None
    deadline_flushed: bool = False

    @property
    def mask(self) -> np.ndarray:
        """The decode mask (last round's mask for multi-round batches)."""
        return self.round_masks[-1]

    @property
    def service_ms(self) -> float:
        return self.complete_ms - self.dispatch_ms




class EngineExecutor:
    """Drives any ``RedundancyScheme`` behind the event loop, on
    ``device`` (``None``: the card).

    ``dispatch`` runs ``scheme.encode`` + ``scheme.forward`` over the
    worker streams (the work the W workers do); ``decode`` applies the
    event-derived mask via ``scheme.decode`` / ``scheme.locate``.  For
    ``BerrutScheme`` that is the pipeline ``coded_inference`` runs (the
    plain masked decode with E = 0, ``locate_and_decode`` with E > 0), so
    outputs match it bit for bit.  The round's ``RoundAttack`` corrupts
    the worker outputs at decode (completion) time, before any locator
    sees them.  Accepts a ``RedundancyScheme`` or a bare
    ``CodingConfig``, which normalizes to ``BerrutScheme``.
    """

    rounds = 1
    supports_speculation = True
    # the scheduler may pass a per-batch ``scheme`` (adaptive redundancy)
    # and a per-round ``locate_quorum`` (degraded rounds) to this executor
    supports_replan = True

    def __init__(self, predict_fn, scheme, wshard=None, device=None):
        self.predict_fn = predict_fn
        self.scheme = as_scheme(scheme)
        # the Berrut CodingConfig, when this is one
        self.coding = getattr(self.scheme, "coding", None)
        # the worker-shard config bounds the gather width a retune may
        # ask for (``check_gather_bound``); one device holds every stream
        self.wshard = wshard
        self.device = resolve_device(device)

    def dispatch(self, queries, scheme=None) -> torch.Tensor:
        scheme = self.scheme if scheme is None else as_scheme(scheme)
        q = torch.as_tensor(np.asarray(queries), device=self.device)
        if q.dtype == torch.float64:
            # float32 serving, as the reference's (JAX's default) arrays
            q = q.float()
        coded = scheme.encode(group_queries(q, scheme.k))
        return scheme.forward(self.predict_fn, coded)

    def step(self, handle, round_idx: int, mask: np.ndarray,
             attack: Optional[RoundAttack] = None,
             locate_quorum: Optional[int] = None):
        raise RuntimeError("single-round executor has no step()")

    def decode(self, handle, mask: np.ndarray,
               attack: Optional[RoundAttack] = None, scheme=None,
               locate_quorum: Optional[int] = None
               ) -> Tuple[np.ndarray, Optional[LocateReport]]:
        scheme = self.scheme if scheme is None else as_scheme(scheme)
        preds = corrupt_coded_preds(handle, attack)
        avail = torch.as_tensor(np.asarray(mask), dtype=preds.dtype,
                                device=preds.device)
        # Locator-aware decode: below the locate quorum (speculative
        # early decodes) error location is hopeless, so decode plainly and
        # let the full decode correct; at or above it, run the scheme's
        # locate -> exclude -> decode pipeline.  ``locate_quorum``
        # overrides the default K+2E threshold on degraded rounds, where
        # quarantine holds have already spent part of the locator budget.
        quorum = (scheme.decode_quorum if locate_quorum is None
                  else locate_quorum)
        if scheme.has_locator and int(np.sum(mask)) >= quorum:
            decoded, located, votes, masks = scheme.locate(preds, avail)
            report = LocateReport(located=np.asarray(located),
                                  votes=np.asarray(votes),
                                  masks=np.asarray(masks))
            return decoded.cpu().numpy(), report
        return scheme.decode(preds, avail, locate=False).cpu().numpy(), None


class CodedScheduler:
    """Discrete-event loop tying arrival, batching, dispatch, and decode.

    ``run`` consumes per-request payloads plus arrival times and returns
    ``ServingMetrics``; per-request outputs land in ``results`` (keyed by
    uid), the provisional SLO-path responses in ``spec_results`` (only
    for speculatively served requests, before their correction), and
    per-batch masks/handles/attacks/locate-reports in ``batches`` for
    verification against a direct ``coded_inference`` call.
    """

    def __init__(self, config: SchedulerConfig, latency_model: LatencyModel,
                 executor):
        self.config = config
        self.latency_model = latency_model
        self.executor = executor
        declared = None
        if config.scheme is not None:
            declared = config.scheme
        elif config.coding is not None:
            declared = as_scheme(config.coding)
        scheme = getattr(executor, "scheme", None)
        if scheme is None:
            if declared is None:
                raise ValueError("SchedulerConfig needs a scheme or "
                                 "coding when the executor carries none")
            scheme = declared
        elif declared is not None and declared.config != scheme.config:
            raise ValueError(
                f"SchedulerConfig declares scheme {declared.name!r} "
                f"({declared.config}) but the executor runs "
                f"{scheme.name!r} ({scheme.config})")
        self.scheme = scheme
        from repro_torch.serving.executor import CodedLLMExecutor
        wshard = getattr(executor, "wshard", None)
        if wshard is not None and isinstance(executor, CodedLLMExecutor):
            # survivor-only decode keeps a fixed gather width; a round
            # that waits for MORE responses than that would silently
            # truncate survivors it paid latency for (DESIGN.md §13).
            # ``is None`` (not truthiness) so an explicit override flows
            # through exactly as in ContinuousScheduler.
            bound = max(scheme.decode_quorum if config.wait_for is None
                        else config.wait_for,
                        scheme.decode_quorum)
            width = wshard.resolved_width(executor.coding)
            if width < bound:
                raise ValueError(
                    f"worker-shard gather width {width} < the scheduler's "
                    f"maximum wait-for {bound}: survivor-only decode would "
                    f"drop responses the round waited for — construct the "
                    f"executor with WorkerShardConfig(gather_width={bound})")
        self.controller = config.controller
        if self.controller is not None:
            if not getattr(executor, "supports_replan", False):
                raise ValueError(
                    "adaptive redundancy needs an executor that re-plans "
                    "per batch (EngineExecutor, CodedLLMExecutor, or the "
                    f"continuous pool); {type(executor).__name__} cannot")
            base = self.controller.base
            if base.name != scheme.name or base.k != scheme.k:
                raise ValueError(
                    f"controller tunes scheme {base.name!r} K={base.k} "
                    f"but the executor runs {scheme.name!r} K={scheme.k}")
            if config.wait_for is not None:
                raise ValueError("wait_for is controller-managed under "
                                 "adaptive redundancy")
            max_w = getattr(executor, "max_replan_workers", None)
            if max_w is not None and \
                    self.controller.pool.num_workers > max_w:
                raise ValueError(
                    f"the controller's maximum operating point dispatches "
                    f"{self.controller.pool.num_workers} workers but the "
                    f"executor's programs cover {max_w}: construct "
                    f"the executor at controller.max_scheme (or declare "
                    f"matching operating_points)")
        # per-worker state (reputation / adversary / churn / latency
        # draws) is sized to the widest pool the run can dispatch to
        pool = self.controller.pool if self.controller is not None \
            else scheme
        self._pool_workers = pool.num_workers
        self.batcher = GroupBatcher(
            scheme, groups_per_batch=config.groups_per_batch,
            flush_deadline_ms=config.flush_deadline_ms,
            class_deadlines=config.class_deadlines)
        self.metrics = ServingMetrics(slo_ms=config.slo_ms)
        self.batches: List[InflightBatch] = []
        self.results: Dict[int, np.ndarray] = {}
        self.spec_results: Dict[int, np.ndarray] = {}
        # Golden-trace event log: one tuple per dispatch / round / spec /
        # retune / completion, in event order; a seeded run reproduces the
        # reference's sequence.
        self.trace: List[tuple] = []
        self._wait_for = (scheme.decode_quorum if config.wait_for is None
                          else config.wait_for)
        if not 1 <= self._wait_for <= scheme.num_workers:
            raise ValueError(f"wait_for={self._wait_for} out of range for "
                             f"{scheme.num_workers} workers")
        self.adversary = make_adversary(pool, config.adversary)
        self.reputation = (WorkerReputation(pool, config.quarantine)
                           if config.quarantine is not None else None)
        self._churn = (WorkerChurn(config.churn, self._pool_workers)
                       if config.churn is not None else None)
        self._rng, self._arrival_seed = derive_seed_streams(config.seed)
        self._events: list = []
        self._seq = itertools.count()
        self._arrival_ms: Dict[int, float] = {}
        self._bid = itertools.count()
        self._now = 0.0

    # -- event plumbing --------------------------------------------------

    def _push(self, t: float, kind: int, data: Any) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), data))

    def run(self, payloads: Sequence[Any],
            arrival_ms: Optional[Sequence[float]] = None,
            rate_rps: Optional[float] = None,
            slo_classes: Optional[Sequence[str]] = None) -> ServingMetrics:
        arrival_ms = resolve_arrivals(len(payloads), arrival_ms, rate_rps,
                                      self._arrival_seed)
        if slo_classes is not None and len(slo_classes) != len(payloads):
            raise ValueError("slo_classes/payloads length mismatch")
        for i, (t, payload) in enumerate(zip(arrival_ms, payloads)):
            cls = DEFAULT_CLASS if slo_classes is None else slo_classes[i]
            self._push(float(t), _ARRIVAL, (payload, cls))
        while self._events or len(self.batcher):
            if not self._events:
                # arrivals exhausted with no flush deadline configured:
                # drain the queue at the current clock
                self._dispatch(self._now, flushed=False, pad="group",
                               force=True)
                continue
            t, kind, _, data = heapq.heappop(self._events)
            self._now = max(self._now, t)
            if kind == _ARRIVAL:
                self._on_arrival(t, data)
            elif kind == _FLUSH:
                self._on_flush(t, data)
            elif kind == _SPEC:
                self._on_spec(t, data)
            elif kind == _ROUND:
                self._on_round(t, *data)
        if self.reputation is not None:
            counts = self.reputation.counts()
            self.metrics.quarantine_events = counts["quarantines"]
            self.metrics.readmissions = counts["readmissions"]
            self.metrics.early_readmissions = counts["early_readmissions"]
        if self._churn is not None:
            leaves, joins = self._churn.events_until(self._now)
            self.metrics.churn_leaves = leaves
            self.metrics.churn_joins = joins
        return self.metrics

    # -- handlers --------------------------------------------------------

    def _on_arrival(self, t: float, data) -> None:
        payload, cls = data
        uid = self.batcher.submit(payload, now=t, slo_class=cls)
        self._arrival_ms[uid] = t
        while self.batcher.ready():
            self._dispatch(t, flushed=False)
        deadline = self.batcher.class_deadline_ms(cls)
        if deadline is not None and uid in self.batcher.pending_uids():
            self._push(t + deadline, _FLUSH, uid)

    def _on_flush(self, t: float, uid: int) -> None:
        # the event was scheduled for ``uid``'s deadline; if uid already
        # dispatched, the oldest pending request (if any) arrived later
        # and its own flush event is still queued
        if self.batcher.deadline_expired(t):
            self._dispatch(t, flushed=True, pad="group")

    def _dispatch(self, now: float, flushed: bool, pad: str = "batch",
                  force: bool = False) -> None:
        plan = self.batcher.next_batch(flush=flushed or force, pad=pad)
        if plan is None:
            return
        # the batch's operating point is pinned at dispatch: the
        # controller may retune BETWEEN batches, never under one
        if self.controller is not None:
            scheme = self.controller.scheme
            wait_target = self.controller.wait_for
        else:
            scheme, wait_target = self.scheme, self._wait_for
        batch = InflightBatch(bid=next(self._bid), plan=plan,
                              queries=self.batcher.stack_payloads(plan),
                              dispatch_plan=scheme.plan(
                                  len(plan.requests) // scheme.k),
                              scheme=scheme, wait_target=wait_target,
                              dispatch_ms=now, deadline_flushed=flushed)
        if self.controller is not None:
            batch.handle = self.executor.dispatch(batch.queries,
                                                  scheme=scheme)
        else:
            batch.handle = self.executor.dispatch(batch.queries)
        self.batches.append(batch)
        self.metrics.batches += 1
        if flushed:
            self.metrics.deadline_flushes += 1
        self.trace.append(("dispatch", batch.bid, now, tuple(plan.uids),
                           flushed))
        self._start_round(batch, now, 0)

    def _start_round(self, batch: InflightBatch, now: float,
                     round_idx: int) -> None:
        """Sample this round's worker completion times, the adversary's
        move, and schedule the adaptive wait-for decode trigger."""
        plan = batch.dispatch_plan
        # latency draws always cover the widest pool (controller runs
        # slice a prefix), so the RNG stream — and therefore the golden
        # trace — does not depend on the controller's decisions
        times = self.latency_model.sample(self._rng, self._pool_workers)
        if plan.num_workers != self._pool_workers:
            times = times[:plan.num_workers]
        # quarantined / churned-out workers are simply not dispatched
        # to: their results never land, so the wait-for selection skips
        # them — and the quorum invariant (apply_pool_state) decides
        # what happens when too few workers remain
        wait, times, degraded, locate_quorum = apply_pool_state(
            batch.scheme, batch.wait_target, times, now,
            reputation=self.reputation, churn=self._churn)
        if degraded:
            self.metrics.degraded_rounds += 1
        mask, trigger = mask_from_completion_times(plan, times,
                                                   wait_for=wait)
        attack = (self.adversary.next_round()
                  if self.adversary is not None else None)
        if attack is not None and len(attack.mask) != plan.num_workers:
            attack = dataclasses.replace(
                attack, mask=attack.mask[:plan.num_workers])
        batch.worker_times.append(times)
        batch.round_masks.append(mask)
        batch.round_quorums.append(locate_quorum)
        batch.round_waits.append(float(trigger))
        batch.round_attacks.append(attack)
        self._push(now + float(trigger), _ROUND, (batch, round_idx))
        last = round_idx == getattr(self.executor, "rounds", 1) - 1
        slo = self.config.slo_ms
        if (last and slo is not None
                and getattr(self.executor, "supports_speculation", False)):
            # the SLO is end-to-end (arrival -> response): speculate so the
            # OLDEST request in the batch still answers by its deadline
            oldest = min(r.arrival_ms for i, r in
                         enumerate(batch.plan.requests) if batch.plan.valid[i])
            target = oldest + slo
            cutoff = target - now          # worker time available pre-SLO
            if now + float(trigger) > target and cutoff > 0:
                landed = (times <= cutoff).astype(np.float32)
                if landed.sum() >= 1:
                    self._push(target, _SPEC, (batch, landed))

    def _on_spec(self, t: float, data) -> None:
        """SLO hit before the quorum: early-decode from whoever landed.

        The round's corruption (if any) is already in flight, so the
        speculative decode sees the same lies the full decode will — the
        E-aware part is in the executor, which skips the locator below
        the K+2E quorum and lets the full decode correct.
        """
        batch, landed = data
        batch.spec_ms = t
        batch.spec_mask = landed
        self.trace.append(("spec", batch.bid, t,
                           tuple(np.flatnonzero(landed).tolist())))
        attack = batch.round_attacks[-1]
        batch.spec_outputs, _ = self._exec_decode(batch, landed, attack)
        self.metrics.speculative_decodes += 1
        for slot, req in enumerate(batch.plan.requests):
            if batch.plan.valid[slot]:
                self.spec_results[req.uid] = batch.spec_outputs[slot]

    def _exec_step(self, batch: InflightBatch, round_idx: int,
                   mask: np.ndarray, attack: Optional[RoundAttack]):
        """The ONE step call shape: re-plannable executors additionally
        get the round's locate quorum; static executors keep the legacy
        signature (so third-party executors don't break)."""
        if getattr(self.executor, "supports_replan", False):
            return self.executor.step(
                batch.handle, round_idx, mask, attack=attack,
                locate_quorum=batch.round_quorums[round_idx])
        return self.executor.step(batch.handle, round_idx, mask,
                                  attack=attack)

    def _exec_decode(self, batch: InflightBatch, mask: np.ndarray,
                     attack: Optional[RoundAttack],
                     locate_quorum: Optional[int] = None):
        """The ONE decode call shape (speculative and final decodes):
        re-plannable executors get the batch's pinned operating point and
        the round's locate quorum (``None`` on speculative decodes, which
        run below the quorum by design)."""
        if getattr(self.executor, "supports_replan", False):
            return self.executor.decode(
                batch.handle, mask, attack=attack, scheme=batch.scheme,
                locate_quorum=locate_quorum)
        return self.executor.decode(batch.handle, mask, attack=attack)

    def _on_round(self, t: float, batch: InflightBatch,
                  round_idx: int) -> None:
        rounds = getattr(self.executor, "rounds", 1)
        mask = batch.round_masks[round_idx]
        attack = batch.round_attacks[round_idx]
        self.trace.append(("round", batch.bid, round_idx, t,
                           tuple(np.flatnonzero(mask).tolist())))
        if round_idx < rounds - 1:
            batch.handle, report = self._exec_step(batch, round_idx, mask,
                                                   attack)
            batch.round_reports.append(report)
            self._observe(t, mask, attack, report)
            self._control(t, batch, round_idx, report)
            self._start_round(batch, t, round_idx + 1)
            return
        batch.outputs, report = self._exec_decode(
            batch, mask, attack,
            locate_quorum=batch.round_quorums[round_idx])
        batch.round_reports.append(report)
        self._observe(t, mask, attack, report)
        self._control(t, batch, round_idx, report)
        batch.complete_ms = t
        self.trace.append(("complete", batch.bid, t))
        corrected = self._corrections(batch)
        for slot, req in enumerate(batch.plan.requests):
            if not batch.plan.valid[slot]:
                continue
            self.results[req.uid] = batch.outputs[slot]
            spec = batch.spec_ms is not None
            self.metrics.record(RequestRecord(
                uid=req.uid,
                arrival_ms=self._arrival_ms[req.uid],
                dispatch_ms=batch.dispatch_ms,
                # a speculative serve answered the client at the SLO; the
                # full decode is the trailing correction
                complete_ms=batch.spec_ms if spec else t,
                speculative=spec,
                corrected=bool(corrected[slot]) if spec else False,
                slo_class=req.slo_class))

    def _observe(self, t: float, mask: np.ndarray,
                 attack: Optional[RoundAttack],
                 report: Optional[LocateReport]) -> None:
        """Score one locate round and feed the quarantine policy."""
        if report is None:
            return
        dispatched, true_corrupt = round_ground_truth(mask, attack)
        detected = report.detected
        # corruption survived if a truly-corrupting worker stayed in any
        # group's decode mask
        decode_corrupt = bool(
            np.any((report.masks >= 0.5) & true_corrupt[None, :]))
        self.metrics.observe_locate(detected, true_corrupt, decode_corrupt)
        if self.reputation is not None:
            # reputation is sized to the widest pool; a narrower batch's
            # verdicts cover a prefix (workers past it: not dispatched)
            self.reputation.observe(t, self._pad_pool(detected),
                                    self._pad_pool(dispatched))

    def _pad_pool(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr, bool)
        if arr.shape[0] == self._pool_workers:
            return arr
        out = np.zeros((self._pool_workers,), bool)
        out[:arr.shape[0]] = arr
        return out

    def _control(self, t: float, batch: InflightBatch, round_idx: int,
                 report: Optional[LocateReport]) -> None:
        """Feed one round's telemetry to the adaptive controller."""
        if self.controller is None:
            return
        before = len(self.controller.decisions)
        held = (int(self.reputation.quarantined.sum())
                if self.reputation is not None else 0)
        decision = self.controller.observe_round(
            t, times=batch.worker_times[round_idx],
            trigger_ms=batch.round_waits[round_idx], report=report,
            quarantined=held)
        self.metrics.control_decisions += \
            len(self.controller.decisions) - before
        if decision is not None:
            check_gather_bound(self.executor, decision.wait_for)
            self.trace.append(("retune", t, decision.num_workers,
                               decision.e, decision.wait_for))

    def _corrections(self, batch: InflightBatch) -> np.ndarray:
        """Per-slot flag: did the full decode revise the speculative
        response?  (argmax flip for logit-like outputs, any element
        change otherwise)."""
        n = len(batch.plan.requests)
        if batch.spec_outputs is None:
            return np.zeros((n,), bool)
        spec, full = np.asarray(batch.spec_outputs), np.asarray(batch.outputs)
        if spec.ndim >= 2:
            changed = (np.argmax(spec, -1) != np.argmax(full, -1))
            changed = changed.reshape(n, -1).any(axis=1)
        else:
            changed = spec != full
        self.metrics.corrections += int(
            np.sum(changed & batch.plan.valid[:n]))
        return changed
