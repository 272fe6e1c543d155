"""Host-side request batcher: groups incoming requests into coded groups.

The prediction-serving front door (paper Fig. 4): requests arrive one at a
time; the batcher fills groups of K, pads the tail group by repeating the
last query (decode for padded slots is discarded), and hands fixed-shape
batches to the jitted coded steps.

Event-clock upgrade (DESIGN.md §8): every request carries its arrival
time, and a ``flush_deadline_ms`` bounds how long the oldest pending
request may wait before the scheduler force-flushes a partial batch.
Deadline flushes pad only to a whole number of groups (``pad="group"``)
so a near-empty queue does not ship a full-size batch of padding.

Multi-tenant SLO classes (DESIGN.md §12): every request belongs to a
deadline class (``slo_class``), each class has its own flush deadline
(``class_deadlines``), and batches NEVER mix classes — an interactive
request is never held hostage by a bulk batch filling up, and a bulk
class with a loose deadline amortizes into fuller batches.  With no
``class_deadlines`` configured everything lands in one ``"default"``
class and the batcher behaves exactly as before.

A copy of ``repro.serving.batcher`` (numpy only): importing the reference
would pull in JAX through its package ``__init__``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional

import numpy as np

DEFAULT_CLASS = "default"


@dataclasses.dataclass
class Request:
    uid: int
    payload: Any                     # modality inputs for one query
    arrival_ms: float = 0.0          # event-clock submit time
    # generation budget for autoregressive serving (continuous batching
    # retires the request at this many generated tokens or at EOS);
    # None means the scheduler's default applies.
    max_new_tokens: Optional[int] = None
    # deadline class for multi-tenant batching (DESIGN.md §12); requests
    # only ever batch with their own class.
    slo_class: str = DEFAULT_CLASS


@dataclasses.dataclass
class BatchPlan:
    requests: List[Request]
    valid: np.ndarray                # (G*K,) bool — padded slots False

    @property
    def uids(self) -> List[int]:
        return [r.uid for r in self.requests]

    @property
    def slo_class(self) -> str:
        return self.requests[0].slo_class


class GroupBatcher:
    """Groups requests into batches of ``groups_per_batch`` groups of K.

    ``scheme`` is anything exposing the group size ``k`` — a
    ``RedundancyScheme`` or a bare ``CodingConfig``; the batcher is
    redundancy-agnostic (it shapes *queries*, not worker streams).

    ``class_deadlines`` maps SLO-class names to per-class flush
    deadlines in ms (``None`` value: that class never deadline-flushes);
    classes not in the map fall back to ``flush_deadline_ms``.
    """

    def __init__(self, scheme, groups_per_batch: int = 1,
                 flush_deadline_ms: Optional[float] = None,
                 class_deadlines: Optional[Dict[str, Optional[float]]]
                 = None):
        self.scheme = scheme
        self.groups = groups_per_batch
        self.flush_deadline_ms = flush_deadline_ms
        self.class_deadlines = dict(class_deadlines or {})
        # per-class FIFO queues, keyed in first-submission order so the
        # tie-breaks below are deterministic for a fixed arrival stream
        self._pending: Dict[str, List[Request]] = {}
        self._uid = itertools.count()

    @property
    def batch_size(self) -> int:
        return self.groups * self.scheme.k

    def __len__(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def class_deadline_ms(self, slo_class: str = DEFAULT_CLASS
                          ) -> Optional[float]:
        """Flush deadline for one class (``None``: never flushes)."""
        return self.class_deadlines.get(slo_class, self.flush_deadline_ms)

    def submit(self, payload: Any, now: float = 0.0,
               max_new_tokens: Optional[int] = None,
               slo_class: str = DEFAULT_CLASS) -> int:
        uid = next(self._uid)
        self._pending.setdefault(slo_class, []).append(
            Request(uid, payload, arrival_ms=now,
                    max_new_tokens=max_new_tokens, slo_class=slo_class))
        return uid

    def ready(self) -> bool:
        n = self.batch_size
        return any(len(q) >= n for q in self._pending.values())

    def pending_uids(self) -> List[int]:
        return [r.uid for q in self._pending.values() for r in q]

    def _class_deadline(self, slo_class: str) -> Optional[float]:
        q = self._pending.get(slo_class)
        if not q:
            return None
        per_class = self.class_deadline_ms(slo_class)
        if per_class is None:
            return None
        return q[0].arrival_ms + per_class

    def oldest_deadline(self) -> Optional[float]:
        """Earliest event time at which some pending request must flush,
        or None when nothing pending carries a deadline."""
        deadlines = [d for d in (self._class_deadline(c)
                                 for c in self._pending) if d is not None]
        return min(deadlines) if deadlines else None

    def deadline_expired(self, now: float) -> bool:
        deadline = self.oldest_deadline()
        return deadline is not None and now >= deadline

    def _pick_class(self, n: int, flush: bool) -> Optional[str]:
        """Deterministically choose which class's queue to pop.

        Full queues win (earliest oldest-arrival first); a flush falls
        back to the non-empty deadline-carrying class whose oldest
        request has waited longest.
        """
        full = [c for c, q in self._pending.items() if len(q) >= n]
        if full:
            return min(full, key=lambda c: self._pending[c][0].arrival_ms)
        if not flush:
            return None
        flushable = [c for c, q in self._pending.items()
                     if q and self.class_deadline_ms(c) is not None]
        if not flushable:
            # no deadline anywhere (e.g. force-drain at end of arrivals):
            # any non-empty class, oldest first
            flushable = [c for c, q in self._pending.items() if q]
        if not flushable:
            return None
        return min(flushable,
                   key=lambda c: self._pending[c][0].arrival_ms)

    def next_batch(self, flush: bool = False, pad: str = "batch",
                   groups: Optional[int] = None) -> Optional[BatchPlan]:
        """Pop a full batch; with ``flush`` pads a partial tail batch.

        ``pad="batch"`` (default) pads to the full ``groups * K`` shape —
        the fixed shape the jitted serving steps want.  ``pad="group"``
        pads a flushed partial batch only to the smallest whole number of
        groups covering the pending requests — what the deadline path
        wants under light load.

        ``groups`` overrides the batch width for THIS call only (the
        admission-queue pop of the continuous scheduler pulls single
        groups regardless of ``groups_per_batch``); the instance state is
        never mutated, so concurrent/reentrant callers are safe.
        """
        if pad not in ("batch", "group"):
            raise ValueError(f"pad must be 'batch' or 'group', got {pad!r}")
        width = self.groups if groups is None else groups
        if width < 1:
            raise ValueError(f"need groups >= 1, got {width}")
        n = width * self.scheme.k
        cls = self._pick_class(n, flush)
        if cls is None:
            return None
        queue = self._pending[cls]
        take = queue[:n]
        self._pending[cls] = queue[n:]
        if len(take) < n and pad == "group":
            n = math.ceil(len(take) / self.scheme.k) * self.scheme.k
        valid = np.ones((n,), bool)
        while len(take) < n:               # pad by repeating the last
            valid[len(take)] = False
            last = take[-1]
            take.append(Request(-1, last.payload,
                                arrival_ms=last.arrival_ms,
                                max_new_tokens=last.max_new_tokens,
                                slo_class=last.slo_class))
        return BatchPlan(requests=take, valid=valid)

    def take_group(self, flush: bool = False) -> Optional[BatchPlan]:
        """Admission-queue pop: exactly ONE group of K (or None).

        The continuous slot-pool scheduler admits at group granularity —
        a full group whenever K requests are pending, or (with ``flush``)
        a deadline-expired partial group padded to K — independent of
        ``groups_per_batch``, which shapes the run-to-completion batches.
        The width is threaded through ``next_batch`` as a parameter, so
        no instance state is touched (reentrant and trace-friendly).
        """
        return self.next_batch(flush=flush, pad="group", groups=1)

    def stack_payloads(self, plan: BatchPlan):
        """Stack per-request payloads into batch arrays.

        Dict payloads (modality dicts) stack per key; bare array payloads
        stack directly into one (B, ...) array.
        """
        first = plan.requests[0].payload
        if isinstance(first, dict):
            return {k: np.stack([r.payload[k] for r in plan.requests])
                    for k in first.keys()}
        return np.stack([r.payload for r in plan.requests])
