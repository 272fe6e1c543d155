"""Batch executor of the coded LLM serving rounds (counterpart of
``repro.serving.scheduler.CodedLLMExecutor``).

A dispatched batch runs ``1 + steps`` coded rounds: round 0 is
``coded_prefill``, each later round one ``coded_decode_step``.  Every
round takes its own straggler mask, an optional ``RoundAttack`` that
corrupts the compromised workers' coded logits before the locator runs
(colluding workers share one noise draw per group), and an optional
``locate_quorum``.  Tokens are selected on the device by ``sample``
(greedy by default; top-k draws come from a ``torch.Generator`` on the
device seeded by ``sample_seed``); the batch returns the (B, steps + 1)
token matrix.

The executor drives the batch event loop (``serving.scheduler.
CodedScheduler``) and re-plans per batch for the adaptive controller.
It is built at its widest operating point; a batch may be dispatched at
a narrower scheme of the same K, whose streams are a prefix of the wide
grid: the rest are held out by a per-stream live mask and the decode
interpolates through the survivors (the reference's masked max-width
re-planning).  With ``operating_points=[(s, e), ...]`` each declared
point instead runs at its own width with no live mask, the counterpart
of the reference's program per point; ``points_visited`` records which
points ran, in the order they were first dispatched.  With ``wshard``
the rounds run worker-major over the active worker group
(``launch.worker_mesh``): each rank holds its own streams and every
rank gets the same tokens.  On an active mesh a rank of the "pod" and
"data" axes runs its block of the streams and a "model" rank its block
of the heads (``serving.coded_serving``).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.berrut import CodingConfig
from repro_torch.core.scheme import BerrutScheme, as_scheme
from repro_torch.launch.worker_mesh import WorkerShardConfig
from repro_torch.serving.coded_serving import (coded_decode_step,
                                               coded_prefill)
from repro_torch.serving.failures import RoundAttack
from repro_torch.serving.sampling import SampleConfig
from repro_torch.serving.scheduler import LocateReport


class CodedLLMExecutor:
    """Runs batches of coded LLM serving rounds on the device of
    ``params``.  The serving state's caches are updated in place each
    round, so a handle's rounds must run once each, in order.
    ``round_ms`` holds each round's wall time (host clock, ending in the
    round's copy of its tokens to the host)."""

    supports_speculation = False
    # the scheduler may pass a per-batch ``scheme`` (an operating point
    # no wider than the executor's) and a per-round ``locate_quorum``
    supports_replan = True

    def __init__(self, model_cfg, coding, params: dict,
                 steps: int, max_len: int,
                 wshard: Optional[WorkerShardConfig] = None,
                 sample: Optional[SampleConfig] = None,
                 sample_seed: int = 0, operating_points=None):
        self.scheme = as_scheme(coding)
        if not isinstance(self.scheme, BerrutScheme):
            raise TypeError("CodedLLMExecutor drives the Berrut coded LLM "
                            "steps; use EngineExecutor for scheme "
                            f"{self.scheme.name!r}")
        self.model_cfg = model_cfg
        self.coding: CodingConfig = self.scheme.coding
        self.params = params
        self.rounds = 1 + steps
        self.max_len = max_len
        self.wshard = wshard
        self.device = params["embeddings"]["embed"].device
        self.sample = sample if sample is not None else SampleConfig()
        self._generator = torch.Generator(self.device).manual_seed(
            sample_seed)
        self.round_ms: List[float] = []
        if operating_points is not None:
            self.operating_points = tuple(
                (int(s), int(e)) for s, e in operating_points)
            self.max_replan_workers = max(
                self.scheme.with_redundancy(s=s, e=e).num_workers
                for s, e in self.operating_points)
        else:
            self.operating_points = None
            self.max_replan_workers = self.coding.num_workers
        self.points_visited: List[tuple] = []

    def _validate_point(self, point: BerrutScheme) -> None:
        if not isinstance(point, BerrutScheme):
            raise TypeError("CodedLLMExecutor operating points must be "
                            f"Berrut schemes, got {point.name!r}")
        if point.k != self.coding.k:
            raise ValueError(f"operating point K={point.k} does not match "
                             f"the executor's K={self.coding.k}")
        if self.operating_points is not None:
            if (point.s, point.e) not in self.operating_points:
                raise ValueError(
                    f"operating point (s={point.s}, e={point.e}) is not "
                    f"in the declared set {self.operating_points}")
        elif point.num_workers > self.coding.num_workers:
            raise ValueError(
                f"operating point needs {point.num_workers} coded streams "
                f"but the executor serves at most {self.coding.num_workers}"
                ": construct it at the controller's maximum point "
                "(controller.max_scheme)")

    def _point_coding(self, point: BerrutScheme) -> CodingConfig:
        """The coding a round of ``point`` runs at: the executor's own
        (the point masked in as a prefix), or with declared operating
        points the point's own."""
        if self.operating_points is None:
            return self.coding
        key = (point.s, point.e)
        if key not in self.points_visited:
            self.points_visited.append(key)
        return point.coding

    def dispatch(self, queries, scheme=None) -> dict:
        """Start a batch of (B, S) token prompts, B a multiple of K, at
        operating point ``scheme`` (default: the executor's own), which
        is pinned for the batch's rounds."""
        point = self.scheme if scheme is None else as_scheme(scheme)
        self._validate_point(point)
        tokens = torch.as_tensor(np.asarray(queries), dtype=torch.int64,
                                 device=self.device)
        if tokens.dim() != 2 or tokens.shape[0] % self.coding.k:
            raise ValueError(f"need (B, S) prompts with B a multiple of "
                             f"K={self.coding.k}, got {tuple(tokens.shape)}")
        return {"tokens": tokens, "state": None, "next": None, "outs": [],
                "round": 0, "scheme": point}

    def _byz_args(self, attack: Optional[RoundAttack], full: int, width: int,
                  groups: int):
        """(byz_mask, noise) padded to the round's ``full`` streams, or
        Nones on a clean round."""
        if attack is None or not attack.active:
            return None, None
        bm = np.zeros((full,), np.float32)
        bm[:width] = np.asarray(attack.mask, np.float32)[:width]
        return (torch.as_tensor(bm, device=self.device),
                attack.noise(groups, full, self.model_cfg.vocab_size,
                             self.device))

    def step(self, handle: dict, round_idx: int, mask: np.ndarray,
             attack: Optional[RoundAttack] = None, locate_quorum=None):
        """Run round ``round_idx`` of the batch with this round's (width,)
        straggler mask; returns the handle and the locator's report (None
        at E = 0).  Every round runs exactly once, in order: the caches
        are updated in place."""
        if round_idx != handle["round"]:
            raise RuntimeError(
                f"round accounting violated: expected round "
                f"{handle['round']}, got {round_idx} (of {self.rounds})")
        t0 = time.perf_counter()
        handle["round"] = round_idx + 1
        point = handle["scheme"]
        coding = self._point_coding(point)
        width, full = point.num_workers, coding.num_workers
        mask = np.asarray(mask, np.float32)
        if mask.shape != (width,):
            raise ValueError(f"round mask covers {mask.shape} workers but "
                             f"the batch's operating point dispatches {width}")
        m = np.zeros((full,), np.float32)
        m[:width] = mask
        live = None
        if width < full:
            live = torch.as_tensor((np.arange(full) < width).astype(
                np.float32), device=self.device)
        groups = handle["tokens"].shape[0] // coding.k
        byz_mask, noise = self._byz_args(attack, full, width, groups)
        kw = dict(straggler_mask=torch.as_tensor(m, device=self.device),
                  byz_mask=byz_mask, byz_noise=noise,
                  byz_sigma=0.0 if attack is None else attack.sigma,
                  with_report=True, sample=self.sample,
                  generator=self._generator, live_mask=live,
                  locate_quorum=0 if locate_quorum is None else locate_quorum,
                  wshard=self.wshard)
        if round_idx == 0:
            toks, state, (located, votes) = coded_prefill(
                self.model_cfg, coding, self.params,
                {"tokens": handle["tokens"]}, self.max_len, **kw)
        else:
            toks, state, (located, votes) = coded_decode_step(
                self.model_cfg, coding, self.params, handle["state"],
                handle["next"], **kw)
        handle["next"], handle["state"] = toks[:, None], state
        handle["outs"].append(toks.cpu().numpy())
        if coding.e == 0:
            report = None
        else:
            # verdicts are sliced to the operating point's width
            located = located.cpu().numpy()[:, :width]
            report = LocateReport(
                located=located, votes=votes.cpu().numpy()[:, :width],
                masks=np.broadcast_to(mask, located.shape)
                * (1.0 - located.astype(np.float32)))
        self.round_ms.append((time.perf_counter() - t0) * 1e3)
        return handle, report

    def decode(self, handle: dict, mask: np.ndarray,
               attack: Optional[RoundAttack] = None, scheme=None,
               locate_quorum=None):
        """Run the batch's last round; returns the (B, steps + 1) token
        matrix and the last round's report."""
        if scheme is not None and \
                as_scheme(scheme).config != handle["scheme"].config:
            raise ValueError("decode scheme does not match the operating "
                             "point pinned at dispatch")
        handle, report = self.step(handle, self.rounds - 1, mask, attack,
                                   locate_quorum)
        outs = np.stack(handle["outs"], axis=1)
        if outs.shape[1] != self.rounds:
            raise RuntimeError(f"emitted {outs.shape[1]} token columns over "
                               f"{self.rounds} rounds")
        return outs, report
