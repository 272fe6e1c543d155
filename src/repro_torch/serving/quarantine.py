"""Per-worker reputation and quarantine policy (DESIGN.md §8).

Every locate round the scheduler feeds the vote-gated Algorithm-2
verdicts into ``WorkerReputation``.  A worker confidently located in
``strikes`` of its last ``window`` dispatches is **quarantined**: the
scheduler stops dispatching to it (its coded stream is pre-masked out of
the adaptive wait-for selection), which removes the corruption from the
decode entirely instead of re-locating it every round.  After a
``probation_ms`` window on the event clock the worker is re-admitted and
must re-offend to be quarantined again — so a transiently-flaky worker
recovers, while a persistent adversary oscillates between short
re-admissions and quarantine.

At most ``coding.e`` workers are quarantined at once (by default): each
quarantined worker permanently spends one unit of the redundancy budget,
and beyond E the scheduler could no longer distinguish fresh adversaries
anyway.  Offenders that cross the strike threshold while the cap is full
go on a **pending** list and are re-evaluated whenever a slot frees
(readmission or early release) — previously they were silently skipped
and only quarantined on a *new* detection after a slot freed.

The quorum invariant (DESIGN.md §12): quarantine holds must never
starve the decode below ``scheme.decode_quorum``.  The scheduler calls
``release_for_quorum`` before sampling a round whose active pool cannot
meet the quorum; the longest-held workers are readmitted early
(recorded as ``"readmit_early"`` events) so the locator always has a
determined system to run on.

A copy of ``repro.serving.quarantine`` (numpy only): importing the reference
would pull in JAX through its package ``__init__``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    """Knobs of the quarantine policy.

    strikes:       confident detections within the window that trigger
                   quarantine.
    window:        how many recent dispatches of a worker count.
    probation_ms:  event-clock quarantine duration before re-admission.
    max_quarantined: concurrent quarantine cap (default: coding E).
    """

    strikes: int = 2
    window: int = 4
    probation_ms: float = 200.0
    max_quarantined: Optional[int] = None

    def __post_init__(self):
        if self.strikes < 1 or self.window < self.strikes:
            raise ValueError(f"need 1 <= strikes <= window, got {self}")
        if self.probation_ms <= 0:
            raise ValueError("probation_ms must be positive")


@dataclasses.dataclass(frozen=True)
class QuarantineEvent:
    """One transition on the event clock ('quarantine', 'readmit', or
    'readmit_early' — a quorum-preserving early release)."""

    t_ms: float
    worker: int
    action: str


class WorkerReputation:
    """Accumulates Algorithm-2 verdicts and drives the quarantine policy."""

    def __init__(self, coding, config: QuarantineConfig):
        # ``coding`` is anything exposing ``num_workers`` and ``e`` — a
        # CodingConfig or any RedundancyScheme.
        self.coding = coding
        self.config = config
        n = coding.num_workers
        self._cap = (coding.e if config.max_quarantined is None
                     else config.max_quarantined)
        self._history: List[Deque[int]] = [
            deque(maxlen=config.window) for _ in range(n)]
        self.detections = np.zeros((n,), np.int64)    # lifetime totals
        self.dispatches = np.zeros((n,), np.int64)
        self._until = np.full((n,), -np.inf)          # quarantined-until
        self._since = np.full((n,), -np.inf)          # quarantined-since
        self._quarantined = np.zeros((n,), bool)
        # offenders over the strike threshold while the cap was full, in
        # the order they crossed it — re-evaluated whenever a slot frees
        self._pending: List[int] = []
        self.events: List[QuarantineEvent] = []

    # -- queries ---------------------------------------------------------

    def active_mask(self, now_ms: float) -> np.ndarray:
        """(N+1,) float32: 1 = dispatch to this worker.  Re-admits workers
        whose probation expired (recording the event), then promotes
        pending offenders into the freed slots."""
        expired = self._quarantined & (self._until <= now_ms)
        for w in np.where(expired)[0]:
            self._quarantined[w] = False
            self.events.append(QuarantineEvent(now_ms, int(w), "readmit"))
        if expired.any():
            self._promote_pending(now_ms)
        return (~self._quarantined).astype(np.float32)

    @property
    def quarantined(self) -> np.ndarray:
        return self._quarantined.copy()

    @property
    def pending_offenders(self) -> List[int]:
        """Workers over the strike threshold awaiting a free slot."""
        return list(self._pending)

    def counts(self) -> Dict[str, int]:
        acts = [e.action for e in self.events]
        return {"quarantines": acts.count("quarantine"),
                "readmissions": (acts.count("readmit")
                                 + acts.count("readmit_early")),
                "early_readmissions": acts.count("readmit_early")}

    # -- updates ---------------------------------------------------------

    def _offending(self, w: int) -> bool:
        """Does worker ``w`` still carry a live strike record?  Clean
        dispatches age strikes out of the window, so a pending offender
        can redeem itself before a slot ever frees."""
        return sum(self._history[w]) >= self.config.strikes

    def _quarantine(self, now_ms: float, w: int) -> QuarantineEvent:
        self._quarantined[w] = True
        self._until[w] = now_ms + self.config.probation_ms
        self._since[w] = now_ms
        self._history[w].clear()
        ev = QuarantineEvent(now_ms, int(w), "quarantine")
        self.events.append(ev)
        return ev

    def _promote_pending(self, now_ms: float) -> List[QuarantineEvent]:
        """Re-evaluate pending offenders against freed capacity."""
        new: List[QuarantineEvent] = []
        still: List[int] = []
        for w in self._pending:
            if self._quarantined[w] or not self._offending(w):
                continue                    # redeemed (or already held)
            if int(self._quarantined.sum()) < self._cap:
                new.append(self._quarantine(now_ms, w))
            else:
                still.append(w)
        self._pending = still
        return new

    def observe(self, now_ms: float, detected: np.ndarray,
                dispatched: np.ndarray) -> List[QuarantineEvent]:
        """Fold one locate round's verdicts into the reputation state.

        detected:   (N+1,) bool — vote-gated located workers this round.
        dispatched: (N+1,) bool/float — workers whose results were used.

        Returns the quarantine events triggered by this observation.
        """
        detected = np.asarray(detected, bool)
        dispatched = np.asarray(dispatched, bool)
        new: List[QuarantineEvent] = []
        self.dispatches += dispatched
        self.detections += detected & dispatched
        for w in np.where(dispatched)[0]:
            self._history[w].append(int(detected[w]))
        cfg = self.config
        for w in np.where(detected & dispatched)[0]:
            if self._quarantined[w] or w in self._pending:
                continue
            if sum(self._history[w]) < cfg.strikes:
                continue
            if int(self._quarantined.sum()) >= self._cap:
                # cap full: remember the offender instead of silently
                # dropping it — it is promoted when a slot frees
                self._pending.append(int(w))
                continue
            new.append(self._quarantine(now_ms, w))
        # a slot may have freed since the last observation (early
        # release / expiry folded by active_mask) — re-check pendings
        new.extend(self._promote_pending(now_ms))
        return new

    def release_for_quorum(self, now_ms: float, need: int,
                           alive: Optional[np.ndarray] = None
                           ) -> List[QuarantineEvent]:
        """Early-readmit the longest-held workers until at least ``need``
        workers are dispatchable (the quorum invariant, DESIGN.md §12).

        ``alive`` (optional (N+1,) bool/float) marks workers that exist
        at all right now (churned-out workers cannot be readmitted into
        the pool by decree).  Returns the early-readmit events.
        """
        alive_b = (np.ones(self._quarantined.shape, bool) if alive is None
                   else np.asarray(alive, bool))
        new: List[QuarantineEvent] = []
        while True:
            active = int((~self._quarantined & alive_b).sum())
            if active >= need:
                break
            held = np.where(self._quarantined & alive_b)[0]
            if held.size == 0:
                break                       # nothing left to release
            w = int(held[np.argmin(self._since[held])])   # longest-held
            self._quarantined[w] = False
            ev = QuarantineEvent(now_ms, w, "readmit_early")
            self.events.append(ev)
            new.append(ev)
        return new
