"""Tail-latency simulation — the paper's §1 motivation, quantified.

A prediction-serving system's response time is the time until enough
workers return.  With per-worker latency L_i ~ base + Pareto tail
(the standard straggler model, Dean & Barroso "The Tail at Scale"):

  * no redundancy:  wait for ALL K workers            (K workers)
  * replication:    each query on S+1 replicas; wait for the fastest
                    replica of EVERY query             ((S+1)K workers)
  * ApproxIFER:     wait for the fastest N+1-S of N+1 coded workers
                    (the decoder needs any K when E=0)  (K+S workers)

The simulator also produces availability masks for the engine: the
workers that had NOT responded at the decode deadline are the stragglers
— wiring wall-clock semantics to the mask-driven decode (DESIGN.md §3).

A copy of ``repro.serving.latency`` (numpy only): importing the reference
would pull in JAX through its package ``__init__``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.berrut import CodingConfig
from repro_torch.core.engine import mask_from_completion_times
from repro_torch.serving.metrics import summarize_latencies


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """base + Pareto-tailed worker latency (heavy-tail stragglers)."""

    base_ms: float = 10.0
    tail_prob: float = 0.05       # fraction of requests that straggle
    pareto_shape: float = 1.5     # heavy tail
    pareto_scale_ms: float = 50.0

    def sample(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        lat = np.full(n, self.base_ms) + rng.exponential(2.0, size=n)
        straggle = rng.rand(n) < self.tail_prob
        tail = self.pareto_scale_ms * (
            rng.pareto(self.pareto_shape, size=n) + 1.0)
        return lat + straggle * tail


# -- production-traffic realism (DESIGN.md §12) --------------------------


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Diurnal + bursty non-homogeneous Poisson arrivals.

    The instantaneous rate is

        rate(t) = base_rate_rps * (1 + diurnal_amp * sin(2*pi*t/period))
                                * (burst_rate_mult   if t inside a burst)

    Burst onsets are themselves a Poisson process (``burst_rate_per_s``);
    each burst lasts ``burst_duration_ms``.  One scaled-down "day" of a
    production frontend: slow diurnal swing, sharp superimposed spikes.
    """

    base_rate_rps: float = 2000.0
    diurnal_period_ms: float = 2000.0
    diurnal_amp: float = 0.6          # in [0, 1): rate swings +- amp
    burst_rate_per_s: float = 2.0     # burst onsets per second
    burst_duration_ms: float = 60.0
    burst_rate_mult: float = 4.0

    def __post_init__(self):
        if self.base_rate_rps <= 0:
            raise ValueError("base_rate_rps must be positive")
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1)")
        if self.burst_rate_mult < 1.0 or self.burst_duration_ms < 0 \
                or self.burst_rate_per_s < 0:
            raise ValueError(f"invalid burst parameters in {self}")

    @property
    def peak_rate_rps(self) -> float:
        return (self.base_rate_rps * (1.0 + self.diurnal_amp)
                * self.burst_rate_mult)

    def rate_rps(self, t_ms: float, burst: bool) -> float:
        r = self.base_rate_rps * (1.0 + self.diurnal_amp * np.sin(
            2.0 * np.pi * t_ms / self.diurnal_period_ms))
        return r * (self.burst_rate_mult if burst else 1.0)


def trace_arrivals(n: int, model: TrafficModel, seed: int = 0,
                   start_ms: float = 0.0) -> np.ndarray:
    """(n,) arrival times in ms drawn from ``model`` by thinning.

    Candidate arrivals are drawn at the peak rate and accepted with
    probability rate(t)/peak — the standard exact sampler for a
    non-homogeneous Poisson process.  Deterministic in ``seed``.
    """
    rng = np.random.RandomState(seed)
    burst_rng = np.random.RandomState(seed + 101)
    out = np.empty((n,), np.float64)
    t = start_ms
    burst_end = -np.inf
    # next burst onset, advanced lazily alongside the candidate clock
    next_burst = start_ms + burst_rng.exponential(
        1e3 / model.burst_rate_per_s) if model.burst_rate_per_s > 0 \
        else np.inf
    got = 0
    peak = model.peak_rate_rps
    while got < n:
        t += rng.exponential(1e3 / peak)
        while t >= next_burst:
            burst_end = max(burst_end, next_burst + model.burst_duration_ms)
            next_burst += burst_rng.exponential(
                1e3 / model.burst_rate_per_s)
        in_burst = t < burst_end
        if rng.rand() < model.rate_rps(t, in_burst) / peak:
            out[got] = t
            got += 1
    return out


@dataclasses.dataclass(frozen=True)
class ChurnModel:
    """Worker churn: each worker alternates up/down on its own clock.

    Up intervals are Exponential(``mean_up_ms``), down intervals
    Exponential(``mean_down_ms``) — an autoscaling pool where workers
    leave (spot preemption, deploys, crashes) and later rejoin.  Leave /
    join events flow through the scheduler exactly like quarantine holds:
    a down worker's completion time is +inf, so the adaptive wait-for
    never waits on it, and the quorum invariant (DESIGN.md §12) decides
    what happens when too few workers remain.
    """

    mean_up_ms: float = 2000.0
    mean_down_ms: float = 200.0
    seed: int = 0

    def __post_init__(self):
        if self.mean_up_ms <= 0 or self.mean_down_ms <= 0:
            raise ValueError(f"churn intervals must be positive, got {self}")


class WorkerChurn:
    """Materialized churn timeline for one worker pool.

    Per-worker alternating up/down toggle times are drawn lazily and
    deterministically (one RNG stream per worker, derived from the model
    seed), so two runs over the same pool see identical churn regardless
    of how often ``alive_mask`` is called.
    """

    def __init__(self, model: ChurnModel, num_workers: int):
        self.model = model
        self.num_workers = num_workers
        root = np.random.RandomState(model.seed)
        self._rngs = [np.random.RandomState(root.randint(0, 2 ** 31 - 1))
                      for _ in range(num_workers)]
        # toggle times per worker: state flips at each entry; all workers
        # start up, so entry 0 is the first leave, entry 1 the rejoin, ...
        self._toggles: List[List[float]] = [[] for _ in range(num_workers)]

    def _extend(self, w: int, until_ms: float) -> None:
        tg = self._toggles[w]
        rng = self._rngs[w]
        m = self.model
        while not tg or tg[-1] <= until_ms:
            last = tg[-1] if tg else 0.0
            mean = m.mean_up_ms if len(tg) % 2 == 0 else m.mean_down_ms
            tg.append(last + rng.exponential(mean))

    def alive_mask(self, now_ms: float) -> np.ndarray:
        """(num_workers,) float32: 1 = worker is in the pool at ``now``."""
        mask = np.ones((self.num_workers,), np.float32)
        for w in range(self.num_workers):
            self._extend(w, now_ms)
            flips = np.searchsorted(np.asarray(self._toggles[w]), now_ms,
                                    side="right")
            mask[w] = 1.0 if flips % 2 == 0 else 0.0
        return mask

    def events_until(self, now_ms: float) -> Tuple[int, int]:
        """(leaves, joins) that happened in [0, now] — churn accounting
        for ``ServingMetrics``."""
        leaves = joins = 0
        for w in range(self.num_workers):
            self._extend(w, now_ms)
            flips = int(np.searchsorted(np.asarray(self._toggles[w]),
                                        now_ms, side="right"))
            leaves += (flips + 1) // 2
            joins += flips // 2
        return leaves, joins


def simulate_no_redundancy(model: LatencyModel, k: int, trials: int,
                           seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    lat = model.sample(rng, trials * k).reshape(trials, k)
    return lat.max(axis=1)


def simulate_replication(model: LatencyModel, k: int, s: int, trials: int,
                         seed: int = 0) -> np.ndarray:
    """(S+1) proactive replicas per query; a query completes at its
    fastest replica; the batch completes at the slowest query."""
    rng = np.random.RandomState(seed)
    lat = model.sample(rng, trials * k * (s + 1)).reshape(trials, k, s + 1)
    return lat.min(axis=2).max(axis=1)


def simulate_approxifer(model: LatencyModel, coding: CodingConfig,
                        trials: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Decoder waits for the fastest ``wait_for`` coded workers.

    Returns (batch latency per trial, straggler masks (trials, N+1)).
    """
    rng = np.random.RandomState(seed)
    n = coding.num_workers
    lat = model.sample(rng, trials * n).reshape(trials, n)
    masks, kth = mask_from_completion_times(coding, lat)
    return kth, masks


def percentile_table(model: LatencyModel, k: int, s: int, trials: int = 20000
                     ) -> dict:
    coding = CodingConfig(k=k, s=s)
    none = simulate_no_redundancy(model, k, trials)
    rep = simulate_replication(model, k, s, trials, seed=1)
    aif, _ = simulate_approxifer(model, coding, trials, seed=2)
    out = {}
    for name, lat, workers in (
            ("none", none, k),
            ("replication", rep, (s + 1) * k),
            ("approxifer", aif, coding.num_workers)):
        out[name] = {"workers": workers, **summarize_latencies(lat)}
    return out
