"""Adaptive redundancy controller: closed-loop (N, E, wait_for) tuning
(DESIGN.md §12); port of ``repro.serving.controller`` (numpy, copied as
it is).

ApproxIFER provisions redundancy statically, N+1 = f(K, S, E) workers
fixed per run, but the serving stack measures everything needed to tune
it online: per-worker completion times, vote-gated locator verdicts,
quarantine occupancy, and per-round decode-trigger latency.
``RedundancyController`` folds one observation per coded round into a
sliding window and, every ``window_rounds`` rounds, re-plans the
operating point through ``RedundancyScheme.with_redundancy``:

  * **grow S** when the straggler rate fattens (or the round-trigger p99
    exceeds ``target_p99_ms``);
  * **grow E** when attacks are confirmed (vote-gated detections) or the
    quarantine is saturated at its cap;
  * **shrink both** after ``clean_windows_to_shrink`` consecutive calm
    windows.

The invariant the controller never trades away: the effective wait-for
of every operating point is that point's ``decode_quorum`` (the K+2E
locator quorum when E > 0).  Decisions are deterministic in the
observation stream: the same seed and arrival trace give the identical
decision log.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.scheme import RedundancyScheme, as_scheme


@dataclasses.dataclass(frozen=True)
class PoolView:
    """Fixed-size view of the worker pool the scheduler's per-worker
    state (reputation, adversary placement, churn) is keyed on: the pool
    at the controller's MAXIMUM operating point.  Operating points with
    fewer workers dispatch to a prefix of this pool, so worker i keeps
    its identity (and its reputation history) across re-plans."""

    num_workers: int
    e: int


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the adaptive redundancy policy (DESIGN.md §12)."""

    window_rounds: int = 16        # rounds per decision window
    s_min: int = 0
    s_max: int = 3
    e_min: int = 0
    e_max: int = 2
    # a dispatched worker slower than this is a straggler for the window
    straggle_ms: float = 50.0
    grow_s_above: float = 0.10     # straggler rate that grows S
    shrink_s_below: float = 0.02   # straggler rate that lets S shrink
    grow_e_above: float = 0.05     # confirmed-attack round rate grows E
    clean_windows_to_shrink: int = 2
    target_p99_ms: Optional[float] = None   # round-trigger p99 target
    # Optional discrete operating-point set: decisions snap to the
    # nearest (s, e) in this set (ties toward MORE redundancy), so a
    # controller can drive an executor that pre-traced exactly these
    # points (``CodedLLMExecutor(operating_points=...)``).
    # Points must lie inside the [s_min, s_max] x [e_min, e_max] box.
    allowed_points: Optional[Tuple[Tuple[int, int], ...]] = None

    def __post_init__(self):
        if self.window_rounds < 1:
            raise ValueError("window_rounds must be >= 1")
        if not 0 <= self.s_min <= self.s_max:
            raise ValueError(f"need 0 <= s_min <= s_max, got {self}")
        if not 0 <= self.e_min <= self.e_max:
            raise ValueError(f"need 0 <= e_min <= e_max, got {self}")
        if self.clean_windows_to_shrink < 1:
            raise ValueError("clean_windows_to_shrink must be >= 1")
        if self.allowed_points is not None:
            pts = tuple((int(s), int(e)) for s, e in self.allowed_points)
            if not pts:
                raise ValueError("allowed_points must be non-empty")
            for s, e in pts:
                if not (self.s_min <= s <= self.s_max
                        and self.e_min <= e <= self.e_max):
                    raise ValueError(
                        f"allowed point (s={s}, e={e}) outside the "
                        f"[{self.s_min}, {self.s_max}] x "
                        f"[{self.e_min}, {self.e_max}] box")
            object.__setattr__(self, "allowed_points", pts)


@dataclasses.dataclass(frozen=True)
class ControlDecision:
    """One retune on the event clock — the golden decision log entry."""

    t_ms: float
    round_idx: int                 # rounds observed when decided
    s: int
    e: int
    num_workers: int               # N+1 at the new operating point
    wait_for: int                  # == the point's decode_quorum
    reason: str


class RedundancyController:
    """Observes serving rounds, retunes (N, E, wait_for) between batches.

    ``scheme`` is the initial operating point (its K is pinned; its S/E
    seed the adaptive state, clamped into the config bounds).  The
    scheduler asks for ``controller.scheme`` / ``controller.wait_for``
    at every dispatch and feeds ``observe_round`` after every decode.
    """

    def __init__(self, scheme, config: Optional[ControllerConfig] = None):
        self.base = as_scheme(scheme)
        self.config = config if config is not None else ControllerConfig()
        cfg = self.config
        self._s = int(np.clip(self.base.s, cfg.s_min, cfg.s_max))
        self._e = int(np.clip(self.base.e, cfg.e_min, cfg.e_max))
        self._s, self._e = self._snap(self._s, self._e)
        self._schemes = {}
        if cfg.allowed_points is not None:
            # the maximal point is the widest allowed one; materialize
            # every declared point up front (an unreachable one fails at
            # construction, and executors may pre-trace the full set)
            for s, e in cfg.allowed_points:
                self._at(s, e)
            self._max = max(
                (self._at(s, e) for s, e in cfg.allowed_points),
                key=lambda sc: (sc.num_workers, sc.e, sc.s))
        else:
            # materialize the corners up front: an unreachable operating
            # point (e.g. ParM at e=1) fails at construction, not mid-run
            self._max = self._at(cfg.s_max, cfg.e_max)
            self._at(cfg.s_min, cfg.e_min)
        self.decisions: List[ControlDecision] = [ControlDecision(
            t_ms=0.0, round_idx=0, s=self._s, e=self._e,
            num_workers=self.scheme.num_workers,
            wait_for=self.wait_for, reason="initial")]
        # sliding-window accumulators
        self._rounds = 0
        self._w_rounds = 0
        self._w_workers = 0
        self._w_stragglers = 0
        self._w_locate_rounds = 0
        self._w_attacked_rounds = 0
        self._w_quarantined_max = 0
        self._w_triggers: List[float] = []
        self._clean_e_windows = 0
        self._calm_s_windows = 0

    # -- operating point -------------------------------------------------

    def _snap(self, s: int, e: int) -> Tuple[int, int]:
        """Snap a requested (s, e) to the nearest allowed operating point
        (identity without ``allowed_points``).  Nearest by L1 distance;
        ties break toward MORE redundancy (larger (e, s)) — when the
        policy wants to move, never under-provision on a coin flip."""
        pts = self.config.allowed_points
        if pts is None or (s, e) in pts:
            return s, e
        return min(pts, key=lambda p: (abs(p[0] - s) + abs(p[1] - e),
                                       -p[1], -p[0]))

    def _at(self, s: int, e: int) -> RedundancyScheme:
        key = (s, e)
        if key not in self._schemes:
            self._schemes[key] = self.base.with_redundancy(s=s, e=e)
        return self._schemes[key]

    @property
    def scheme(self) -> RedundancyScheme:
        """The current operating point's scheme."""
        return self._at(self._s, self._e)

    @property
    def wait_for(self) -> int:
        """Effective wait-for — pinned to the operating point's decode
        quorum (the invariant: never below it)."""
        return self.scheme.decode_quorum

    @property
    def max_scheme(self) -> RedundancyScheme:
        """The MAXIMUM operating point's scheme: what a re-planning
        executor (``CodedLLMExecutor`` / ``ContinuousLLMExecutor``) must
        be constructed at so every narrower point is a maskable prefix
        of its grid."""
        return self._max

    @property
    def pool(self) -> PoolView:
        """The maximal pool the per-worker state is sized to."""
        return PoolView(num_workers=self._max.num_workers,
                        e=self._max.e)

    def decision_log(self) -> List[Tuple[int, int, int, int]]:
        """Compact (num_workers, e, wait_for, round_idx) tuples — the
        golden-determinism artifact."""
        return [(d.num_workers, d.e, d.wait_for, d.round_idx)
                for d in self.decisions]

    # -- observation -----------------------------------------------------

    def observe_round(self, now_ms: float, times: np.ndarray,
                      trigger_ms: float, report=None,
                      quarantined: int = 0) -> Optional[ControlDecision]:
        """Fold one coded round's telemetry into the window; decide at
        window boundaries.  Returns the decision if one was made.

        times:      (W,) per-worker completion times for the dispatched
                    pool (inf = held/absent worker, excluded from the
                    straggler statistic).
        trigger_ms: the round's decode-trigger latency (wait-for-th
                    order statistic).
        report:     the round's ``LocateReport`` (None when no locator
                    ran); ``report.detected`` is the vote-gated verdict.
        quarantined: concurrent quarantine holds at observation time.
        """
        t = np.asarray(times, np.float64)
        finite = np.isfinite(t)
        self._rounds += 1
        self._w_rounds += 1
        self._w_workers += int(finite.sum())
        self._w_stragglers += int(
            np.sum(finite & (t > self.config.straggle_ms)))
        if report is not None:
            self._w_locate_rounds += 1
            if bool(np.asarray(report.detected).any()):
                self._w_attacked_rounds += 1
        self._w_quarantined_max = max(self._w_quarantined_max,
                                      int(quarantined))
        if np.isfinite(trigger_ms):
            self._w_triggers.append(float(trigger_ms))
        if self._w_rounds < self.config.window_rounds:
            return None
        return self._decide(now_ms)

    # -- decision rule (DESIGN.md §12) -----------------------------------

    def _decide(self, now_ms: float) -> Optional[ControlDecision]:
        cfg = self.config
        straggler_rate = (self._w_stragglers / self._w_workers
                          if self._w_workers else 0.0)
        attack_rate = (self._w_attacked_rounds / self._w_locate_rounds
                       if self._w_locate_rounds else 0.0)
        p99 = (float(np.percentile(self._w_triggers, 99.0))
               if self._w_triggers else 0.0)
        cap = self._at(self._s, self._e).e   # current hold capacity
        s, e = self._s, self._e
        reasons = []

        # Byzantine axis: widen on confirmed attacks or a saturated
        # quarantine; narrow only after sustained calm.
        saturated = cap > 0 and self._w_quarantined_max >= cap
        if (attack_rate > cfg.grow_e_above or saturated) and e < cfg.e_max:
            e += 1
            reasons.append(
                f"attacks {attack_rate:.2f}/round" if
                attack_rate > cfg.grow_e_above else "quarantine saturated")
            self._clean_e_windows = 0
        elif attack_rate == 0.0 and self._w_quarantined_max == 0:
            self._clean_e_windows += 1
            if self._clean_e_windows >= cfg.clean_windows_to_shrink \
                    and e > cfg.e_min:
                e -= 1
                reasons.append("clean windows, shed locator budget")
                self._clean_e_windows = 0
        else:
            self._clean_e_windows = 0

        # Straggler axis: widen on fat tails (rate or p99 target);
        # narrow only after sustained calm.
        slow = (straggler_rate > cfg.grow_s_above
                or (cfg.target_p99_ms is not None
                    and p99 > cfg.target_p99_ms))
        calm = (straggler_rate < cfg.shrink_s_below
                and (cfg.target_p99_ms is None
                     or p99 < 0.8 * cfg.target_p99_ms))
        if slow and s < cfg.s_max:
            s += 1
            reasons.append(f"stragglers {straggler_rate:.2f}"
                           if straggler_rate > cfg.grow_s_above
                           else f"p99 {p99:.1f}ms over target")
            self._calm_s_windows = 0
        elif calm:
            self._calm_s_windows += 1
            if self._calm_s_windows >= cfg.clean_windows_to_shrink \
                    and s > cfg.s_min:
                s -= 1
                reasons.append("calm tail, shed standby")
                self._calm_s_windows = 0
        else:
            self._calm_s_windows = 0

        self._reset_window()
        s, e = self._snap(s, e)
        if (s, e) == (self._s, self._e):
            return None
        self._s, self._e = s, e
        point = self.scheme
        decision = ControlDecision(
            t_ms=now_ms, round_idx=self._rounds, s=s, e=e,
            num_workers=point.num_workers, wait_for=self.wait_for,
            reason="; ".join(reasons))
        self.decisions.append(decision)
        return decision

    def _reset_window(self) -> None:
        self._w_rounds = 0
        self._w_workers = 0
        self._w_stragglers = 0
        self._w_locate_rounds = 0
        self._w_attacked_rounds = 0
        self._w_quarantined_max = 0
        self._w_triggers = []
