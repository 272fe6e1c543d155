"""Continuous-batching coded LLM serving over a fixed coded-KV slot pool
(DESIGN.md §10); port of ``repro.serving.continuous``.

A persistent round loop over a fixed-capacity slot pool replaces the
batch lifecycle:

  * Every pool round runs ``pool_groups x (N+1)`` coded streams
    (``coded_serving.coded_pool_prefill`` / ``coded_pool_decode_step``);
    a group slot is live or free, never a different shape.
  * Groups join at prefill mid-flight: whenever slots are free and a
    group of K requests is ready (or its flush deadline expired), the
    next pool round admits it alongside the in-flight groups' decode.
  * Requests retire independently on per-request EOS /
    ``max_new_tokens``; a group's slot frees when its last request
    retires.
  * Every stream decodes at its own cache depth (the per-slot ``pos``
    vector, kept on the device); the decode hands those depths, and at
    E == 0 the slot-live mask, to ``ops.pool_decode_attention``, whose
    CUDA kernel reads only each stream's valid ring slots.

Every pool round is one coded dispatch: per-worker completion times are
sampled once, the round fires when the fastest ``wait_for`` coded
workers land, and the round's straggler mask (and Byzantine attack)
applies to both the admissions' prefill and the actives' decode.
``mode="run_to_completion"`` only admits into an empty pool, the
batch-scoped baseline at an equal worker pool.

The reference donates the pool state to its jitted steps; here the steps
write the pool caches in place, and the prefill's fresh caches are
allocated once per executor.  The numpy event loop is the reference's,
draw for draw, so a seed gives the same event trace in both.  With
``wshard=`` the pool is worker-major over the active worker group
(``launch.worker_mesh``): each rank keeps only its own streams' caches,
and the token ids come back the same on every rank, so every rank runs
the same host loop on the same data.  On a (worker, model) mesh the
parameters are a rank's blocks (``launch.shardings.local_shard``) and
each pool cache holds its block of the kv-heads, or where the model axis
does not divide them its block of the ring slots
(``models.attention.RingBlock``); the prefill's fresh caches take the
same layout, so admission copies whole streams.  With ``controller=`` a
``RedundancyController`` retunes (N, E, wait_for) between rounds: the
executor is built at the controller's maximum operating point and a
narrower point dispatches to a prefix of its streams, the rest held out
by the per-round ``live_mask``.  On "pod" and "data" axes the pool and
the prefill scratch hold a rank's block of the streams
(``coded_serving.pool_streams``); the round's tail runs on the gathered
streams, the same on each rank of those axes, so every rank's top-k
generator draws the same tokens and advances alike.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.berrut import CodingConfig
from repro_torch.core.engine import mask_from_completion_times
from repro_torch.core.scheme import BerrutScheme, as_scheme
from repro_torch.launch.worker_mesh import WorkerShardConfig
from repro_torch.models.model import init_caches, param_dtype
from repro_torch.serving.batcher import GroupBatcher
from repro_torch.serving.controller import RedundancyController
from repro_torch.serving.coded_serving import (coded_pool_decode_step,
                                               coded_pool_prefill,
                                               init_pool_state, pool_streams)
from repro_torch.serving.failures import (AdversaryConfig, RoundAttack,
                                          make_adversary)
from repro_torch.serving.latency import (ChurnModel, LatencyModel,
                                         WorkerChurn)
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.quarantine import QuarantineConfig, WorkerReputation
from repro_torch.serving.sampling import SampleConfig
from repro_torch.serving.scheduler import (LocateReport, apply_pool_state,
                                           check_gather_bound,
                                           derive_seed_streams,
                                           resolve_arrivals,
                                           round_ground_truth)

# Event kinds; numeric order breaks timestamp ties (arrivals land before
# a flush deadline at the same instant, which lands before a round).
_ARRIVAL, _FLUSH, _ROUND = 0, 1, 2

_MODES = ("continuous", "run_to_completion")


@dataclasses.dataclass(frozen=True)
class ContinuousConfig:
    """Knobs of the slot-pool serving runtime."""

    coding: Optional[CodingConfig] = None
    pool_groups: int = 4               # fixed group-slot capacity
    flush_deadline_ms: Optional[float] = 2.0
    slo_ms: Optional[float] = None     # goodput accounting only
    seed: int = 0
    wait_for: Optional[int] = None     # None -> scheme.decode_quorum
    adversary: Optional[AdversaryConfig] = None
    quarantine: Optional[QuarantineConfig] = None
    # worker churn on the event clock (DESIGN.md §12); a churned-out
    # worker's results never land, exactly like a quarantine hold.
    churn: Optional[ChurnModel] = None
    # adaptive (N, E, wait_for) retuning between rounds; the executor is
    # built at the controller's MAXIMUM operating point and narrower
    # points are masked off per round by the live mask
    controller: Optional[RedundancyController] = None
    # "continuous": admit into free slots every round;
    # "run_to_completion": admit only into an EMPTY pool.
    mode: str = "continuous"
    max_new_tokens: int = 8            # default per-request budget
    eos_token_id: Optional[int] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got "
                             f"{self.mode!r}")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")


@dataclasses.dataclass
class SlotGroup:
    """One admitted group of K requests living in a pool slot."""

    gid: int
    slot: int
    plan: Any                          # BatchPlan (K requests, valid mask)
    admit_ms: float
    budget: np.ndarray                 # (K,) per-request max_new_tokens
    done: np.ndarray                   # (K,) bool (padding: done at birth)
    gen: np.ndarray                    # (K,) generated-token counts
    prefilled: bool = False
    deadline_flushed: bool = False


class ContinuousLLMExecutor:
    """Drives the slot-pool serving steps behind the round loop, on the
    device of ``params``.

    Admissions, retirements, partial groups and straggler / Byzantine
    masks are all data, so every call runs the same shapes.  Tokens are
    selected on the device by ``sample`` (greedy by default); top-k draws
    come from a ``torch.Generator`` on the device seeded by
    ``sample_seed``, the same on every rank of a worker group.  Each call
    consumes the state it is given (the pool caches are written in
    place) and returns the new one, with the (P*K,) int32 token ids and
    the locator's report copied to the host in one transfer: that is the
    call's only host sync.  ``prefill_calls`` / ``decode_calls`` count
    the calls and ``call_ms`` holds each call's wall time (host clock,
    ending in that sync).  ``byz_collude`` must match the adversary's
    behaviour model for the run, as in the reference.

    ``live_mask`` on ``prefill``/``decode`` is the round's per-stream
    operating-point mask (adaptive redundancy): streams beyond the
    point's width are composed out of the straggler mask in the step.
    """

    supports_replan = True

    def __init__(self, model_cfg, coding, params, pool_groups: int,
                 max_len: int, byz_collude: bool = False,
                 sample: Optional[SampleConfig] = None,
                 sample_seed: int = 0,
                 wshard: Optional[WorkerShardConfig] = None):
        self.scheme = as_scheme(coding)
        if not isinstance(self.scheme, BerrutScheme):
            raise TypeError("ContinuousLLMExecutor drives the Berrut "
                            f"slot-pool steps, not scheme "
                            f"{self.scheme.name!r}")
        self.coding = self.scheme.coding
        self.model_cfg = model_cfg
        self.params = params
        self.pool_groups = pool_groups
        self.max_len = max_len
        self.byz_collude = byz_collude
        self.sample = sample if sample is not None else SampleConfig()
        self.wshard = wshard
        self.device = params["embeddings"]["embed"].device
        self._generator = torch.Generator(self.device).manual_seed(
            sample_seed)
        self.max_replan_workers = self.coding.num_workers
        self._fresh = None               # prefill scratch, pool-shaped
        self.prefill_calls = 0
        self.decode_calls = 0
        self.call_ms: Dict[str, List[float]] = {"prefill": [], "decode": []}

    def init_state(self):
        # one cache dtype for the pool and its prefill scratch, whatever
        # leaves the runs' caches have (an SSM run has no "k")
        dtype = param_dtype(self.model_cfg)
        state = init_pool_state(self.model_cfg, self.coding,
                                self.pool_groups, self.max_len, self.device,
                                cache_dtype=dtype, wshard=self.wshard)
        self._fresh = init_caches(
            self.model_cfg,
            pool_streams(self.coding, self.pool_groups, self.wshard),
            self.max_len, dtype, self.device)
        return state

    def _byz_args(self, attack: Optional[RoundAttack]):
        """(byz_mask, noise, sigma) of the round, Nones when clean."""
        if attack is None or not attack.active:
            return None, None, 0.0
        if bool(attack.collude) != self.byz_collude:
            raise ValueError(
                f"adversary collude={attack.collude} does not match the "
                f"executor's byz_collude={self.byz_collude}")
        mask = torch.as_tensor(np.asarray(attack.mask, np.float32),
                               device=self.device)
        noise = attack.noise(self.pool_groups, self.coding.num_workers,
                             self.model_cfg.vocab_size, self.device)
        return mask, noise, float(attack.sigma)

    def _step_kwargs(self, mask: np.ndarray, attack: Optional[RoundAttack],
                     live_mask, locate_quorum) -> dict:
        bm, noise, sigma = self._byz_args(attack)
        live = None
        if live_mask is not None and not np.all(np.asarray(live_mask) > 0):
            # an all-live round composes to the same mask: skip the copy
            live = torch.as_tensor(np.asarray(live_mask, np.float32),
                                   device=self.device)
        return dict(
            live_mask=live,
            straggler_mask=torch.as_tensor(np.asarray(mask, np.float32),
                                           device=self.device),
            byz_mask=bm, byz_noise=noise, byz_sigma=sigma, with_report=True,
            sample=self.sample, generator=self._generator,
            locate_quorum=0 if locate_quorum is None else locate_quorum,
            wshard=self.wshard)

    def _to_host(self, kind: str, t0: float, toks: torch.Tensor, state,
                 report, mask: np.ndarray):
        """(host token ids, state, LocateReport or None): the call's one
        device-to-host transfer, and its wall time."""
        located, votes = report
        n = toks.shape[0]
        if self.coding.e == 0:
            toks, rep = toks.cpu().numpy(), None
        else:
            g, w = located.shape
            host = torch.cat([toks.to(torch.int32),
                              located.to(torch.int32).flatten(),
                              votes.to(torch.int32).flatten()]).cpu().numpy()
            toks = host[:n]
            located = host[n:n + g * w].reshape(g, w).astype(bool)
            rep = LocateReport(
                located=located, votes=host[n + g * w:].reshape(g, w),
                masks=np.broadcast_to(mask, (g, w))
                * (1.0 - located.astype(np.float32)))
        self.call_ms[kind].append((time.perf_counter() - t0) * 1e3)
        return toks, state, rep

    def prefill(self, state, prompts: np.ndarray, admit_mask: np.ndarray,
                mask: np.ndarray, attack: Optional[RoundAttack] = None,
                live_mask: Optional[np.ndarray] = None,
                locate_quorum: Optional[int] = None):
        """Consumes ``state``; returns ((P*K,) int32 token ids, new state,
        locate report)."""
        if self._fresh is None:
            raise RuntimeError("call init_state() before serving")
        t0 = time.perf_counter()
        self.prefill_calls += 1
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        toks, state, report = coded_pool_prefill(
            self.model_cfg, self.coding, self.params, state,
            {"tokens": tokens}, np.asarray(admit_mask, np.float32),
            fresh=self._fresh,
            **self._step_kwargs(mask, attack, live_mask, locate_quorum))
        return self._to_host("prefill", t0, toks, state, report, mask)

    def decode(self, state, tokens: np.ndarray, active_mask: np.ndarray,
               mask: np.ndarray, attack: Optional[RoundAttack] = None,
               live_mask: Optional[np.ndarray] = None,
               locate_quorum: Optional[int] = None):
        """Consumes ``state``; returns ((P*K,) int32 token ids, new state,
        locate report)."""
        t0 = time.perf_counter()
        self.decode_calls += 1
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.device)
        toks, state, report = coded_pool_decode_step(
            self.model_cfg, self.coding, self.params, state, tokens,
            np.asarray(active_mask, np.float32),
            **self._step_kwargs(mask, attack, live_mask, locate_quorum))
        return self._to_host("decode", t0, toks, state, report, mask)


class ContinuousScheduler:
    """Discrete-event round loop over the fixed coded-KV slot pool.

    ``run`` consumes per-request token prompts plus arrival times (and
    per-request generation budgets) and returns ``ServingMetrics``;
    per-request generated-token arrays land in ``results`` (keyed by
    uid, variable length — requests retire independently).  ``trace``
    is the golden event log: one tuple per admission / round / request
    retirement / slot free, in event order, bit-reproducible for a
    fixed seed.
    """

    def __init__(self, config: ContinuousConfig,
                 latency_model: LatencyModel,
                 executor: ContinuousLLMExecutor):
        self.config = config
        self.latency_model = latency_model
        self.executor = executor
        scheme = executor.scheme
        if (config.coding is not None
                and as_scheme(config.coding).config != scheme.config):
            raise ValueError(
                f"ContinuousConfig declares coding {config.coding} but "
                f"the executor runs {scheme.config}")
        if config.pool_groups != executor.pool_groups:
            raise ValueError(
                f"ContinuousConfig.pool_groups={config.pool_groups} but "
                f"the executor's pool has {executor.pool_groups} slots")
        wait_for = (scheme.decode_quorum if config.wait_for is None
                    else config.wait_for)
        self.controller = config.controller
        if self.controller is not None:
            if not getattr(executor, "supports_replan", False):
                raise ValueError(
                    "adaptive redundancy needs an executor that re-plans "
                    f"per round; {type(executor).__name__} cannot")
            base = self.controller.base
            if base.name != scheme.name or base.k != scheme.k:
                raise ValueError(
                    f"controller tunes scheme {base.name!r} K={base.k} "
                    f"but the executor runs {scheme.name!r} K={scheme.k}")
            if config.wait_for is not None:
                raise ValueError("wait_for is controller-managed under "
                                 "adaptive redundancy")
            max_w = getattr(executor, "max_replan_workers",
                            scheme.num_workers)
            if self.controller.pool.num_workers > max_w:
                raise ValueError(
                    f"the controller's maximum operating point dispatches "
                    f"{self.controller.pool.num_workers} workers but the "
                    f"executor's pool covers {max_w}: construct the "
                    f"executor at controller.max_scheme")
        wshard = getattr(executor, "wshard", None)
        if wshard is not None:
            # survivor-only decode keeps a fixed gather width; a round
            # waiting for more responses than that would silently drop
            # survivors it paid latency for (DESIGN.md §13)
            bound = max(wait_for, scheme.decode_quorum)
            width = wshard.resolved_width(executor.coding)
            if width < bound:
                raise ValueError(
                    f"worker-shard gather width {width} < the pool's "
                    f"maximum wait-for {bound}: survivor-only decode would "
                    f"drop responses the round waited for — construct the "
                    f"executor with WorkerShardConfig(gather_width={bound})")
        self.scheme = scheme
        self.pool_groups = executor.pool_groups
        self.batcher = GroupBatcher(
            scheme, groups_per_batch=1,
            flush_deadline_ms=config.flush_deadline_ms)
        self.metrics = ServingMetrics(slo_ms=config.slo_ms)
        self.results: Dict[int, np.ndarray] = {}
        self.groups: List[SlotGroup] = []       # every admitted group
        self.trace: List[tuple] = []            # golden event log
        # per-round dispatch widths (num_workers at the round's operating
        # point): the adaptive runs' cost axis
        self.round_widths: List[int] = []
        self._wait_for = wait_for
        if not 1 <= self._wait_for <= scheme.num_workers:
            raise ValueError(f"wait_for={self._wait_for} out of range for "
                             f"{scheme.num_workers} workers")
        self.adversary = make_adversary(scheme, config.adversary)
        if (self.adversary is not None
                and (config.adversary.kind == "colluding")
                != executor.byz_collude):
            raise ValueError(
                "executor byz_collude must be True exactly for the "
                "colluding adversary")
        self.reputation = (WorkerReputation(scheme, config.quarantine)
                           if config.quarantine is not None else None)
        self._churn = (WorkerChurn(config.churn, scheme.num_workers)
                       if config.churn is not None else None)
        self._rng, self._arrival_seed = derive_seed_streams(config.seed)
        self._events: list = []
        self._seq = itertools.count()
        self._gid = itertools.count()
        self._arrival_ms: Dict[int, float] = {}
        self._first_ms: Dict[int, float] = {}
        self._outs: Dict[int, list] = {}
        self._now = 0.0
        self._round_idx = 0
        self._inflight = False
        self._force = False
        self._slots: List[Optional[SlotGroup]] = [None] * self.pool_groups
        self._free: List[int] = list(range(self.pool_groups))
        self._state = executor.init_state()
        self._prompt_buf: Optional[np.ndarray] = None
        self._token_buf = np.zeros((self.pool_groups * scheme.k, 1),
                                   np.int32)

    # -- event plumbing --------------------------------------------------

    def _push(self, t: float, kind: int, data: Any) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), data))

    def _occupied(self) -> bool:
        return any(g is not None for g in self._slots)

    @property
    def rounds_run(self) -> int:
        return self._round_idx

    def run(self, payloads: Sequence[np.ndarray],
            arrival_ms: Optional[Sequence[float]] = None,
            rate_rps: Optional[float] = None,
            max_new_tokens: Optional[Any] = None) -> ServingMetrics:
        """Serve ``payloads`` (uniform-length int32 token prompts).

        ``max_new_tokens``: scalar or per-request sequence of generation
        budgets (default ``config.max_new_tokens`` for all) — the mixed
        generation lengths continuous batching exists to exploit.
        """
        arrival_ms = resolve_arrivals(len(payloads), arrival_ms, rate_rps,
                                      self._arrival_seed)
        if max_new_tokens is None:
            budgets = [self.config.max_new_tokens] * len(payloads)
        elif np.ndim(max_new_tokens) == 0:
            budgets = [int(max_new_tokens)] * len(payloads)
        else:
            budgets = [int(b) for b in max_new_tokens]
            if len(budgets) != len(payloads):
                raise ValueError("max_new_tokens/payloads length mismatch")
        if any(b < 1 for b in budgets):
            raise ValueError("per-request max_new_tokens must be >= 1")
        shapes = {np.shape(p) for p in payloads}
        if len(shapes) != 1:
            raise ValueError(f"prompts must share one fixed shape (the "
                             f"pool prompt buffer), got {sorted(shapes)}")
        (prompt_len,) = shapes.pop()
        self._prompt_buf = np.zeros(
            (self.pool_groups * self.scheme.k, prompt_len), np.int32)
        for t, payload, budget in zip(arrival_ms, payloads, budgets):
            self._push(float(t), _ARRIVAL, (payload, budget))
        while self._events or len(self.batcher) or self._occupied():
            if not self._events:
                # arrivals exhausted with no flush deadline configured:
                # admit the remaining partial group at the current clock
                self._try_start_round(self._now, force=True)
                if not self._events:
                    break
                continue
            t, kind, _, data = heapq.heappop(self._events)
            self._now = max(self._now, t)
            if kind == _ARRIVAL:
                self._on_arrival(t, data)
            elif kind == _FLUSH:
                self._on_flush(t, data)
            elif kind == _ROUND:
                self._on_round(t, data)
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
        payload, budget = data
        uid = self.batcher.submit(payload, now=t, max_new_tokens=budget)
        self._arrival_ms[uid] = t
        self._outs[uid] = []
        self._try_start_round(t)
        if self.batcher.flush_deadline_ms is not None and uid in \
                self.batcher.pending_uids():
            self._push(t + self.batcher.flush_deadline_ms, _FLUSH, uid)

    def _on_flush(self, t: float, uid: int) -> None:
        # if the round loop is spinning, the deadline check happens at
        # the next round boundary anyway; when idle, this event wakes it
        if not self._inflight and self.batcher.deadline_expired(t):
            self._try_start_round(t)

    def _admit(self, now: float) -> List[SlotGroup]:
        """Move ready (or deadline-expired) groups into free slots."""
        if (self.config.mode == "run_to_completion" and self._occupied()):
            return []                   # batch-scoped baseline: drain first
        admitted: List[SlotGroup] = []
        k = self.scheme.k
        while self._free:
            flush = self._force or self.batcher.deadline_expired(now)
            plan = self.batcher.take_group(flush=flush)
            if plan is None:
                break
            slot = self._free.pop(0)
            n_valid = int(plan.valid.sum())
            group = SlotGroup(
                gid=next(self._gid), slot=slot, plan=plan, admit_ms=now,
                budget=np.asarray(
                    [r.max_new_tokens or self.config.max_new_tokens
                     for r in plan.requests], np.int64),
                done=~plan.valid.copy(), gen=np.zeros((k,), np.int64),
                deadline_flushed=n_valid < k)
            rows = slice(slot * k, (slot + 1) * k)
            self._prompt_buf[rows] = np.stack(
                [np.asarray(r.payload, np.int32) for r in plan.requests])
            self._slots[slot] = group
            self.groups.append(group)
            admitted.append(group)
            self.metrics.batches += 1
            if group.deadline_flushed:
                self.metrics.deadline_flushes += 1
            self.trace.append(("admit", group.gid, slot, now,
                               tuple(plan.uids), group.deadline_flushed))
        return admitted

    def _try_start_round(self, now: float, force: bool = False) -> None:
        if self._inflight:
            return
        self._force = force
        admitted = self._admit(now)
        self._force = False
        active = [g for g in self._slots if g is not None and g.prefilled]
        if not admitted and not active:
            return
        full = self.scheme.num_workers
        # the round's operating point is pinned here: the controller may
        # retune BETWEEN rounds, never under one.  A narrower point
        # dispatches to a PREFIX of the executor's streams; the rest are
        # masked off by the live mask.
        if self.controller is not None:
            point = self.controller.scheme
            wait_target = self.controller.wait_for
        else:
            point, wait_target = self.scheme, self._wait_for
        width = point.num_workers
        # latency draws always cover the widest pool (adaptive rounds
        # slice a prefix), so the RNG stream, and the golden trace, does
        # not depend on the controller's decisions
        times = self.latency_model.sample(self._rng, full)
        # quarantined / churned-out workers are pre-masked out of the
        # wait-for selection; the quorum invariant (apply_pool_state,
        # DESIGN.md §12) early-readmits held workers rather than let the
        # round silently wait below the K+2E locator quorum
        wait, times_w, degraded, locate_quorum = apply_pool_state(
            point, wait_target, times[:width], now,
            reputation=self.reputation, churn=self._churn)
        if degraded:
            self.metrics.degraded_rounds += 1
        mask_w, trigger = mask_from_completion_times(point, times_w,
                                                     wait_for=wait)
        attack = (self.adversary.next_round()
                  if self.adversary is not None else None)
        # the round's mask and attack live at the executor's width;
        # streams beyond the operating point are not dispatched (mask 0),
        # so the adversary cannot corrupt through them either
        mask = np.zeros((full,), np.float32)
        mask[:width] = mask_w
        if attack is not None and width < full:
            am = np.array(attack.mask, np.float32)
            am[width:] = 0.0
            attack = dataclasses.replace(attack, mask=am)
        self._inflight = True
        self.round_widths.append(width)
        self.trace.append(("round", self._round_idx, now,
                           tuple(g.gid for g in admitted),
                           tuple(g.gid for g in active),
                           tuple(np.flatnonzero(mask).tolist())))
        self._push(now + float(trigger), _ROUND,
                   (admitted, active, mask, attack, width, locate_quorum,
                    times_w, float(trigger)))

    def _on_round(self, t: float, data) -> None:
        (admitted, active, mask, attack, width, locate_quorum, times_w,
         trigger) = data
        self._inflight = False
        self.metrics.rounds += 1
        pool = self.pool_groups
        live = (np.arange(self.scheme.num_workers) < width).astype(
            np.float32)
        reports = []
        if admitted:
            admit_mask = np.zeros((pool,), np.float32)
            admit_mask[[g.slot for g in admitted]] = 1.0
            tokens, self._state, report = self.executor.prefill(
                self._state, self._prompt_buf, admit_mask, mask, attack,
                live_mask=live, locate_quorum=locate_quorum)
            reports.append((report, admit_mask))
            for g in admitted:
                g.prefilled = True
                self._emit(g, tokens, t, first=True)
        if active:
            act_mask = np.zeros((pool,), np.float32)
            act_mask[[g.slot for g in active]] = 1.0
            tokens, self._state, report = self.executor.decode(
                self._state, self._token_buf, act_mask, mask, attack,
                live_mask=live, locate_quorum=locate_quorum)
            reports.append((report, act_mask))
            for g in active:
                self._emit(g, tokens, t, first=False)
        self._observe(t, mask, attack, reports)
        self._control(t, times_w, trigger, reports)
        for g in admitted + active:
            if g.done.all() and self._slots[g.slot] is g:
                self._slots[g.slot] = None
                self._free.append(g.slot)
                self._free.sort()
                self.trace.append(("free", g.gid, g.slot, t))
        self._round_idx += 1
        self._try_start_round(t)

    def _emit(self, group: SlotGroup, tokens: np.ndarray, t: float,
              first: bool) -> None:
        """Consume this round's on-device-sampled token column for one
        group; retire requests that hit their budget or EOS.  ``tokens``
        is the (pool_groups*K,) int32 id vector the executor returned —
        token selection already happened on the device, so the only
        per-round device->host traffic is this id vector (and the
        locator's report)."""
        k = self.scheme.k
        rows = slice(group.slot * k, (group.slot + 1) * k)
        toks = tokens[rows].astype(np.int32)
        live = ~group.done                       # before this round's token
        self._token_buf[rows, 0] = toks
        eos = self.config.eos_token_id
        for i, req in enumerate(group.plan.requests):
            if not live[i]:
                continue
            uid = req.uid
            self._outs[uid].append(int(toks[i]))
            group.gen[i] += 1
            if first:
                self._first_ms[uid] = t
            if group.gen[i] >= group.budget[i] or \
                    (eos is not None and int(toks[i]) == eos):
                group.done[i] = True
                self.results[uid] = np.asarray(self._outs[uid], np.int32)
                self.trace.append(("retire", uid, group.gid, t,
                                   int(group.gen[i])))
                self.metrics.record(RequestRecord(
                    uid=uid,
                    arrival_ms=self._arrival_ms[uid],
                    dispatch_ms=group.admit_ms,
                    complete_ms=t,
                    first_token_ms=self._first_ms[uid],
                    tokens=int(group.gen[i])))

    def _observe(self, t: float, mask: np.ndarray,
                 attack: Optional[RoundAttack],
                 reports: List[tuple]) -> None:
        """Score ONE locate observation for the whole pool round.

        A mixed round issues two calls (admissions' prefill +
        actives' decode) but is still one coded dispatch — one mask, one
        attack — so their reports merge into a single observation: a
        second strike per round would quarantine workers twice as fast
        as the legacy scheduler under an identical config.  Each
        report is already composed with its live-slot mask
        (free slots locate nothing); the per-call group mask restricts
        the corrupted-decode check to rows that were actually decoded —
        corruption "surviving" into a free slot's zeroed logits is not a
        robustness failure.
        """
        reports = [(r, gm) for r, gm in reports if r is not None]
        if not reports:
            return
        dispatched, true_corrupt = round_ground_truth(mask, attack)
        # a slot is admitted OR active in a round, never both, so the
        # reports' live rows are disjoint and merge by union
        detected = np.zeros_like(dispatched)
        decode_corrupt = False
        for report, group_mask in reports:
            detected |= report.detected
            live = group_mask >= 0.5
            decode_corrupt |= bool(
                np.any((report.masks[live] >= 0.5) & true_corrupt[None, :]))
        self.metrics.observe_locate(detected, true_corrupt, decode_corrupt)
        if self.reputation is not None:
            self.reputation.observe(t, detected, dispatched)

    def _control(self, t: float, times_w: np.ndarray, trigger: float,
                 reports: List[tuple]) -> None:
        """Feed one pool round's telemetry to the adaptive controller.

        The mixed round's per-call reports merge into ONE observation
        (concatenated along the group axis; ``detected`` is their union),
        as in ``_observe``: one coded dispatch, one strike.  ``times_w``
        are the operating point's sliced completion times, so the
        straggle statistic matches what the round dispatched.
        """
        if self.controller is None:
            return
        live = [r for r, _ in reports if r is not None]
        merged = None
        if live:
            merged = LocateReport(
                located=np.concatenate([r.located for r in live]),
                votes=np.concatenate([r.votes for r in live]),
                masks=np.concatenate([r.masks for r in live]))
        before = len(self.controller.decisions)
        held = (int(self.reputation.quarantined.sum())
                if self.reputation is not None else 0)
        decision = self.controller.observe_round(
            t, times=times_w, trigger_ms=trigger, report=merged,
            quarantined=held)
        self.metrics.control_decisions += \
            len(self.controller.decisions) - before
        if decision is not None:
            check_gather_bound(self.executor, decision.wait_for)
            self.trace.append(("retune", t, decision.num_workers,
                               decision.e, decision.wait_for))
