"""Host-side pieces of the event-driven coded serving scheduler (port of
the parts of ``repro.serving.scheduler`` that the slot-pool loop reads).

Arrival clocks, the scheduler's seed streams, scoring a locate round
against the adversary's ground truth, and the quarantine/churn quorum
invariant (``apply_pool_state``, DESIGN.md §12) are numpy and copied as
they are.  ``LocateReport`` is the host copy of one round's locator
verdicts, shared by the batch and the slot-pool executors.
``CodedScheduler``, ``EngineExecutor`` and ``SchedulerConfig`` are not
ported yet (ROADMAP A5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


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
class LocateReport:
    """One locate round's verdicts (host-side copies of the jitted
    pipeline's outputs, per group)."""

    located: np.ndarray               # (G, N+1) bool, vote-gated
    votes: np.ndarray                 # (G, N+1) int32
    masks: np.ndarray                 # (G, N+1) decode masks actually used

    @property
    def detected(self) -> np.ndarray:
        """(N+1,) bool — located in at least one group this round."""
        return self.located.any(axis=0)
