"""Per-request serving metrics: latency percentiles and goodput.

The offline simulator (`serving/latency.py`) reports batch completion
times in a vacuum; the event-driven scheduler (DESIGN.md §8) measures the
full request lifecycle instead — arrival, queueing in the batcher,
dispatch, and decode — so the paper's tail-latency claim (§1, Fig. 4) is
observed end to end, including batching delay.

A copy of ``repro.serving.metrics`` (numpy only): importing the reference
would pull in JAX through its package ``__init__``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

PERCENTILES = (("p50_ms", 50.0), ("p99_ms", 99.0), ("p999_ms", 99.9))


def summarize_latencies(latencies_ms) -> Dict[str, float]:
    """p50/p99/p99.9 over a latency sample (shared with the offline
    percentile tables so the two report formats line up)."""
    lat = np.asarray(latencies_ms, np.float64)
    if lat.size == 0:
        return {name: float("nan") for name, _ in PERCENTILES}
    return {name: float(np.percentile(lat, q)) for name, q in PERCENTILES}


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Lifecycle of one served request (all times on the event clock)."""

    uid: int
    arrival_ms: float
    dispatch_ms: float
    complete_ms: float            # when the response left the scheduler
    speculative: bool = False     # served by the SLO early-decode path
    corrected: bool = False       # a later full decode revised the output
    # -- autoregressive serving (continuous batching, DESIGN.md §10) --
    first_token_ms: Optional[float] = None   # when the first token shipped
    tokens: int = 0               # generated tokens (0: single-shot serve)
    # multi-tenant deadline class (DESIGN.md §12)
    slo_class: str = "default"

    @property
    def latency_ms(self) -> float:
        return self.complete_ms - self.arrival_ms

    @property
    def queue_ms(self) -> float:
        return self.dispatch_ms - self.arrival_ms

    @property
    def service_ms(self) -> float:
        return self.complete_ms - self.dispatch_ms

    @property
    def ttft_ms(self) -> Optional[float]:
        """Time to first token (arrival -> first generated token)."""
        if self.first_token_ms is None:
            return None
        return self.first_token_ms - self.arrival_ms

    @property
    def itl_ms(self) -> Optional[float]:
        """Mean inter-token latency over the request's decode tail."""
        if self.first_token_ms is None or self.tokens < 2:
            return None
        return (self.complete_ms - self.first_token_ms) / (self.tokens - 1)


class ServingMetrics:
    """Accumulates request records and derives the serving scoreboard."""

    def __init__(self, slo_ms: Optional[float] = None):
        self.slo_ms = slo_ms
        self.records: List[RequestRecord] = []
        self.batches = 0
        self.rounds = 0               # coded pool rounds (continuous path)
        self.deadline_flushes = 0     # batches dispatched by deadline
        self.speculative_decodes = 0  # batches early-decoded at the SLO
        self.corrections = 0          # speculative outputs later revised
        # -- Byzantine pipeline (DESIGN.md §8): one observation per coded
        # round on which the locator ran, scored against the adversary's
        # ground truth --
        self.locate_rounds = 0        # rounds the locator ran on
        self.attacked_rounds = 0      # rounds with corruption in the decode set
        self.detection_tp = 0         # located & truly corrupting
        self.detection_fp = 0         # located but honest
        self.detection_fn = 0         # corrupting but not located
        self.corrupted_decodes = 0    # rounds where corruption survived
        self.quarantine_events = 0    # workers placed in quarantine
        self.readmissions = 0         # workers re-admitted after probation
        self.early_readmissions = 0   # quorum-preserving early releases
        # -- quorum invariant + production-traffic realism (DESIGN.md §12):
        # a round is "degraded" when the dispatchable pool could not meet
        # scheme.decode_quorum even after early readmission (worker churn
        # can shrink the pool below any quota quarantine controls) --
        self.degraded_rounds = 0
        self.churn_leaves = 0         # workers that left the pool (churn)
        self.churn_joins = 0          # workers that (re)joined the pool
        self.control_decisions = 0    # adaptive (N, E, wait_for) retunes

    def record(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def observe_locate(self, detected, true_corrupt, decode_corrupt: bool
                       ) -> None:
        """Score one locate round against the adversary's ground truth.

        detected:       (N+1,) bool — vote-gated located workers.
        true_corrupt:   (N+1,) bool — workers that actually corrupted this
                        round AND whose results entered the decode set.
        decode_corrupt: did corruption survive into any group's decode?
        """
        detected = np.asarray(detected, bool)
        true_corrupt = np.asarray(true_corrupt, bool)
        self.locate_rounds += 1
        self.attacked_rounds += int(true_corrupt.any())
        self.detection_tp += int(np.sum(detected & true_corrupt))
        self.detection_fp += int(np.sum(detected & ~true_corrupt))
        self.detection_fn += int(np.sum(~detected & true_corrupt))
        self.corrupted_decodes += int(decode_corrupt)

    # -- derived views ---------------------------------------------------

    @property
    def count(self) -> int:
        return len(self.records)

    def latencies_ms(self) -> np.ndarray:
        return np.asarray([r.latency_ms for r in self.records], np.float64)

    def queue_ms(self) -> np.ndarray:
        return np.asarray([r.queue_ms for r in self.records], np.float64)

    def percentiles(self) -> Dict[str, float]:
        return summarize_latencies(self.latencies_ms())

    def percentiles_by_class(self) -> Dict[str, Dict[str, float]]:
        """Per-SLO-class latency percentiles (multi-tenant serving)."""
        out: Dict[str, Dict[str, float]] = {}
        for cls in sorted({r.slo_class for r in self.records}):
            out[cls] = summarize_latencies(
                [r.latency_ms for r in self.records if r.slo_class == cls])
        return out

    def makespan_ms(self) -> float:
        if not self.records:
            return 0.0
        t0 = min(r.arrival_ms for r in self.records)
        t1 = max(r.complete_ms for r in self.records)
        return max(t1 - t0, 1e-9)

    def throughput_rps(self) -> float:
        """Completed requests per second of event time."""
        return self.count / self.makespan_ms() * 1e3

    def ttft_ms(self) -> np.ndarray:
        """Time-to-first-token sample (autoregressively served requests
        only — single-shot records carry no first-token timestamp)."""
        return np.asarray([r.ttft_ms for r in self.records
                           if r.first_token_ms is not None], np.float64)

    def itl_ms(self) -> np.ndarray:
        """Per-request mean inter-token latencies (>= 2 tokens)."""
        return np.asarray([r.itl_ms for r in self.records
                           if r.itl_ms is not None], np.float64)

    def generated_tokens(self) -> int:
        return int(sum(r.tokens for r in self.records))

    def tokens_per_s(self) -> float:
        """Generated tokens per second of event time."""
        return self.generated_tokens() / self.makespan_ms() * 1e3

    def detection_precision(self) -> float:
        """Of the workers the locator confidently flagged, how many were
        truly corrupting?  NaN until a detection happened."""
        den = self.detection_tp + self.detection_fp
        return self.detection_tp / den if den else float("nan")

    def detection_recall(self) -> float:
        """Of the truly-corrupting workers in decode sets, how many were
        flagged?  NaN until an attacked round was observed."""
        den = self.detection_tp + self.detection_fn
        return self.detection_tp / den if den else float("nan")

    def corrupted_decode_rate(self) -> float:
        """Fraction of locate rounds where corruption survived into a
        decode (the robustness failure rate under attack)."""
        return (self.corrupted_decodes / self.locate_rounds
                if self.locate_rounds else 0.0)

    def goodput_rps(self, slo_ms: Optional[float] = None) -> float:
        """Requests served WITHIN the SLO per second of event time.

        Without an SLO every completed request counts (== throughput).
        """
        slo = self.slo_ms if slo_ms is None else slo_ms
        if slo is None:
            return self.throughput_rps()
        good = int(np.sum(self.latencies_ms() <= slo))
        return good / self.makespan_ms() * 1e3

    def summary(self) -> Dict[str, float]:
        out = dict(self.percentiles())
        out.update(
            requests=float(self.count),
            batches=float(self.batches),
            deadline_flushes=float(self.deadline_flushes),
            speculative_decodes=float(self.speculative_decodes),
            corrections=float(self.corrections),
            mean_queue_ms=(float(self.queue_ms().mean())
                           if self.records else float("nan")),
            throughput_rps=self.throughput_rps(),
            goodput_rps=self.goodput_rps(),
        )
        ttft = self.ttft_ms()
        if ttft.size:
            itl = self.itl_ms()
            out.update(
                rounds=float(self.rounds),
                p50_ttft_ms=float(np.percentile(ttft, 50.0)),
                p99_ttft_ms=float(np.percentile(ttft, 99.0)),
                mean_itl_ms=(float(itl.mean()) if itl.size
                             else float("nan")),
                generated_tokens=float(self.generated_tokens()),
                tokens_per_s=self.tokens_per_s(),
            )
        if self.locate_rounds:
            out.update(
                locate_rounds=float(self.locate_rounds),
                attacked_rounds=float(self.attacked_rounds),
                detection_precision=self.detection_precision(),
                detection_recall=self.detection_recall(),
                corrupted_decode_rate=self.corrupted_decode_rate(),
                quarantine_events=float(self.quarantine_events),
                readmissions=float(self.readmissions),
            )
        if self.degraded_rounds or self.early_readmissions:
            out.update(degraded_rounds=float(self.degraded_rounds),
                       early_readmissions=float(self.early_readmissions))
        if self.churn_leaves or self.churn_joins:
            out.update(churn_leaves=float(self.churn_leaves),
                       churn_joins=float(self.churn_joins))
        if self.control_decisions:
            out.update(control_decisions=float(self.control_decisions))
        return out

    def format_table(self) -> str:
        s = self.summary()
        lines = [
            f"requests {self.count}  batches {self.batches} "
            f"(deadline-flushed {self.deadline_flushes})",
            f"latency  p50 {s['p50_ms']:.2f}ms  p99 {s['p99_ms']:.2f}ms  "
            f"p99.9 {s['p999_ms']:.2f}ms  (queue {s['mean_queue_ms']:.2f}ms "
            "mean)",
            f"goodput  {s['goodput_rps']:.1f} req/s"
            + (f" at SLO {self.slo_ms:.1f}ms" if self.slo_ms else ""),
        ]
        if self.ttft_ms().size:
            lines.append(
                f"ttft     p50 {s['p50_ttft_ms']:.2f}ms  "
                f"p99 {s['p99_ttft_ms']:.2f}ms  itl "
                f"{s['mean_itl_ms']:.2f}ms mean  "
                f"({s['generated_tokens']:.0f} tokens over "
                f"{s['rounds']:.0f} rounds, "
                f"{s['tokens_per_s']:.1f} tok/s)")
        if self.speculative_decodes:
            lines.append(
                f"speculative decodes {self.speculative_decodes}  "
                f"corrections {self.corrections}")
        if self.locate_rounds:
            lines.append(
                f"byzantine {self.attacked_rounds}/{self.locate_rounds} "
                f"rounds attacked  precision "
                f"{self.detection_precision():.2f}  recall "
                f"{self.detection_recall():.2f}  corrupted-decode rate "
                f"{self.corrupted_decode_rate():.3f}")
            if self.quarantine_events:
                lines.append(
                    f"quarantines {self.quarantine_events}  "
                    f"readmissions {self.readmissions}"
                    + (f" (early {self.early_readmissions})"
                       if self.early_readmissions else ""))
        if self.degraded_rounds:
            lines.append(f"degraded rounds {self.degraded_rounds} "
                         "(pool below decode quorum)")
        if self.churn_leaves or self.churn_joins:
            lines.append(f"churn    {self.churn_leaves} leaves  "
                         f"{self.churn_joins} joins")
        if self.control_decisions:
            lines.append(f"adaptive redundancy decisions "
                         f"{self.control_decisions}")
        return "\n".join(lines)
