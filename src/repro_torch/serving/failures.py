"""Straggler / Byzantine failure simulation (port of
``repro.serving.failures``; masks and adversaries in numpy).

Failures are availability masks over the coded-stream axis (worst case,
paper Appendix C) and additive-noise corruption for Byzantine workers
(paper §4.2).  Beyond the paper's memoryless corruption, a stateful
adversary (DESIGN.md §8) keeps a fixed set of compromised workers that
corrupt persistently, intermittently (Bernoulli per coded dispatch), or
in collusion (one corruption vector shared by the whole compromised
subset).  The scheduler's event loop samples one ``RoundAttack`` per
coded dispatch.

The reference carries a ``jax.random`` key per round for the noise; here
a ``RoundAttack`` carries an integer ``seed`` for a ``torch.Generator``,
drawn from its own numpy stream so that the adversary's behaviour stream
(placement, then one draw per round for the non-persistent kinds) is
consumed exactly as the reference consumes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.berrut import CodingConfig

ADVERSARY_KINDS = ("none", "persistent", "intermittent", "colluding")


def sample_straggler_mask(coding: CodingConfig, rng: np.random.RandomState,
                          num_stragglers: int | None = None) -> np.ndarray:
    """(N+1,) float32 mask with ``num_stragglers`` (default S) random zeros."""
    s = coding.s if num_stragglers is None else num_stragglers
    if s > coding.s:
        raise ValueError(f"{s} stragglers > tolerated S={coding.s}")
    mask = np.ones((coding.num_workers,), np.float32)
    if s:
        idx = rng.choice(coding.num_workers, size=s, replace=False)
        mask[idx] = 0.0
    return mask


def sample_byzantine_mask(coding: CodingConfig, rng: np.random.RandomState,
                          num_errors: int | None = None) -> np.ndarray:
    """(N+1,) float32, 1 = worker is Byzantine, at random locations."""
    e = coding.e if num_errors is None else num_errors
    if e > coding.e:
        raise ValueError(f"{e} errors > tolerated E={coding.e}")
    mask = np.zeros((coding.num_workers,), np.float32)
    if e:
        idx = rng.choice(coding.num_workers, size=e, replace=False)
        mask[idx] = 1.0
    return mask


def worst_case_straggler_mask(coding: CodingConfig) -> np.ndarray:
    """Drop the S boundary-adjacent interior nodes, whose removal
    maximises decode error."""
    mask = np.ones((coding.num_workers,), np.float32)
    if coding.s:
        mask[1:1 + coding.s] = 0.0
    return mask


def worst_case_byzantine_placement(coding,
                                   num_errors: int | None = None
                                   ) -> np.ndarray:
    """The E boundary-adjacent interior worker indices, alternating ends
    (1, N-1, 2, ...), where the locator's majority vote has the thinnest
    margin."""
    e = coding.e if num_errors is None else num_errors
    n = coding.num_workers
    order = []
    lo, hi = 1, n - 2
    while lo <= hi and len(order) < e:
        order.append(lo)
        if len(order) < e and hi != lo:
            order.append(hi)
        lo, hi = lo + 1, hi - 1
    return np.asarray(order[:e], np.int64)


def worst_case_byzantine_mask(coding: CodingConfig,
                              num_errors: int | None = None) -> np.ndarray:
    """(N+1,) float32, 1 = Byzantine, placed where location is hardest."""
    mask = np.zeros((coding.num_workers,), np.float32)
    mask[worst_case_byzantine_placement(coding, num_errors)] = 1.0
    return mask


@dataclasses.dataclass(frozen=True)
class AdversaryConfig:
    """Which workers lie, when, and how loudly.

    kind:        "none" | "persistent" (every dispatch) | "intermittent"
                 (Bernoulli(attack_rate) per dispatch) | "colluding"
                 (Bernoulli(attack_rate); the whole compromised subset
                 applies the SAME corruption vector).
    num_adversaries: size of the compromised set (default E).
    attack_rate: per-dispatch corruption probability (not read by
                 "persistent").
    sigma:       corruption noise scale.
    placement:   "random" or "worst_case".
    """

    kind: str = "persistent"
    num_adversaries: Optional[int] = None
    attack_rate: float = 1.0
    sigma: float = 50.0
    placement: str = "random"
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ADVERSARY_KINDS:
            raise ValueError(f"unknown adversary kind {self.kind!r}; "
                             f"expected one of {ADVERSARY_KINDS}")
        if not 0.0 <= self.attack_rate <= 1.0:
            raise ValueError(f"attack_rate must be in [0, 1], got "
                             f"{self.attack_rate}")
        if self.placement not in ("random", "worst_case"):
            raise ValueError(f"unknown placement {self.placement!r}")


@dataclasses.dataclass(frozen=True)
class RoundAttack:
    """One coded dispatch's corruption.

    ``mask`` (N+1,) marks the workers corrupting this round (all zeros on
    rounds the adversary sits out); each adds ``sigma`` times standard
    normal noise drawn from a ``torch.Generator`` seeded with ``seed``.
    With ``collude`` the corrupting workers of a group all add the same
    noise: one (G, 1, V) draw per round instead of (G, N+1, V).
    """

    mask: np.ndarray                  # (N+1,) float32, 1 = corrupts now
    sigma: float
    collude: bool = False
    seed: int = 0

    @property
    def active(self) -> bool:
        return bool(self.mask.sum() > 0)

    def noise(self, groups: int, workers: int, vocab: int,
              device) -> torch.Tensor:
        """The round's standard normal noise on ``device``: (G, N+1, V),
        or (G, 1, V) when the group's corrupting workers collude."""
        gen = torch.Generator(device).manual_seed(self.seed)
        shape = (groups, 1 if self.collude else workers, vocab)
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)


class Adversary:
    """Stateful adversary: a fixed compromised worker set + per-dispatch
    behaviour.  ``next_round()`` is called once per coded dispatch.
    ``coding`` is anything exposing ``num_workers`` and ``e``."""

    def __init__(self, coding, config: AdversaryConfig):
        self.coding = coding
        self.config = config
        self._rng = np.random.RandomState(config.seed)
        # the noise seeds' own stream; never drawn from ``_rng``
        self._noise_seeds = np.random.RandomState(config.seed + 1)
        m = (coding.e if config.num_adversaries is None
             else config.num_adversaries)
        m = min(m, coding.num_workers)
        if config.kind == "none" or m == 0:
            self.workers = np.zeros((0,), np.int64)
        elif config.placement == "worst_case":
            self.workers = worst_case_byzantine_placement(coding, m)
        else:
            self.workers = np.sort(self._rng.choice(
                coding.num_workers, size=m, replace=False))
        self.byz_mask = np.zeros((coding.num_workers,), np.float32)
        self.byz_mask[self.workers] = 1.0
        self.rounds = 0
        self.attacked_rounds = 0

    def next_round(self) -> RoundAttack:
        """Sample this dispatch's corruption (advances both streams)."""
        self.rounds += 1
        cfg = self.config
        attacks = (len(self.workers) > 0
                   and (cfg.kind == "persistent"
                        or self._rng.rand() < cfg.attack_rate))
        seed = int(self._noise_seeds.randint(0, 2 ** 31 - 1))
        if not attacks:
            return RoundAttack(
                mask=np.zeros((self.coding.num_workers,), np.float32),
                sigma=cfg.sigma, collude=False, seed=seed)
        self.attacked_rounds += 1
        return RoundAttack(mask=self.byz_mask.copy(), sigma=cfg.sigma,
                           collude=cfg.kind == "colluding", seed=seed)


def make_adversary(coding,
                   config: Optional[AdversaryConfig]) -> Optional[Adversary]:
    if config is None or config.kind == "none":
        return None
    return Adversary(coding, config)


def corrupt_coded_preds(preds: torch.Tensor,
                        attack: Optional[RoundAttack]) -> torch.Tensor:
    """Apply one round's corruption to (G, N+1, ...) coded predictions.

    Persistent/intermittent workers add independent ``sigma``-scaled
    normal noise; colluding workers all add the SAME noise tensor (drawn
    once per group, broadcast over the worker axis).  Deterministic in
    ``attack.seed``, so recomputing for a speculative and a full decode
    yields identical lies.
    """
    if attack is None or not attack.active:
        return preds
    g, n, rest = preds.shape[0], preds.shape[1], preds.shape[2:]
    noise = attack.noise(g, n, math.prod(rest), preds.device).reshape(
        g, 1 if attack.collude else n, *rest).to(preds.dtype)
    m = torch.as_tensor(np.asarray(attack.mask), dtype=preds.dtype,
                        device=preds.device).reshape(1, n, *[1] * len(rest))
    return preds + attack.sigma * m * noise
