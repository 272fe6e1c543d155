"""Redundancy schemes behind one protocol (port of ``repro.core.scheme``,
the Berrut scheme only).

A scheme has static parameters (K, S, E, worker width, wait-for, decode
quorum, whether it has a locator), re-plans at another (S, E) with
``with_redundancy``, and serves one batch through the lifecycle

    plan(groups)      -> DispatchPlan (worker-pool width, wait-for quorum)
    encode(grouped)   -> per-worker payloads     (G, K, ...) -> (G, W, ...)
    forward(f, coded) -> worker outputs          (G, W, ...) -> (G, W, C)
    decode(outputs, avail)  -> recovered predictions          (G*K, C)
    locate(outputs, avail)  -> decoded + locator verdicts / votes / masks

that the event loop and ``EngineExecutor`` are written against.
``as_scheme`` wraps a bare ``CodingConfig``.  ``get_scheme("berrut")``
works; the reference's other registered schemes are named here so that
asking for one says it is not ported yet, rather than unknown.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import berrut as berrut_mod
from repro_torch.core.berrut import CodingConfig
from repro_torch.core.engine import decode_coded_preds, locate_and_decode


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """How one batch of ``groups`` query-groups is spread over workers.

    ``num_workers`` is the worker-pool width W (streams per group);
    ``wait_for`` the offline decode trigger; ``decode_quorum`` the
    minimal adaptive wait-for the online scheduler may drop to.
    """

    scheme: str
    groups: int
    k: int
    num_workers: int
    wait_for: int
    decode_quorum: int

    @property
    def queries(self) -> int:
        return self.groups * self.k

    @property
    def overhead(self) -> float:
        """workers per query: the paper's resource-overhead metric."""
        return self.num_workers / self.k


class RedundancyScheme:
    """Base class / protocol: ``name`` and a frozen, hashable ``config``
    exposing ``k, s, e, num_workers, wait_for, decode_quorum``."""

    name: str = "base"

    def __init__(self, config: Any):
        self.config = config

    @property
    def k(self) -> int:
        return self.config.k

    @property
    def s(self) -> int:
        return self.config.s

    @property
    def e(self) -> int:
        return self.config.e

    @property
    def num_workers(self) -> int:
        return self.config.num_workers

    @property
    def wait_for(self) -> int:
        return self.config.wait_for

    @property
    def decode_quorum(self) -> int:
        return self.config.decode_quorum

    @property
    def overhead(self) -> float:
        return self.num_workers / self.k

    @property
    def has_locator(self) -> bool:
        """Whether the scheme has an error locator (E > 0 for Berrut)."""
        return False

    def plan(self, groups: int) -> DispatchPlan:
        if groups < 1:
            raise ValueError(f"need groups >= 1, got {groups}")
        return DispatchPlan(scheme=self.name, groups=groups, k=self.k,
                            num_workers=self.num_workers,
                            wait_for=self.wait_for,
                            decode_quorum=self.decode_quorum)

    # -- lifecycle -------------------------------------------------------

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        """(G, K, ...) real queries -> (G, W, ...) worker payloads."""
        raise NotImplementedError

    def forward(self, predict_fn: Callable[[torch.Tensor], torch.Tensor],
                coded: torch.Tensor) -> torch.Tensor:
        """Run the hosted model over every worker stream: all W streams
        run the same model f."""
        g, w = coded.shape[:2]
        preds = predict_fn(coded.reshape(g * w, *coded.shape[2:]))
        return preds.reshape(g, w, *preds.shape[1:])

    def decode(self, outputs: torch.Tensor, avail: torch.Tensor, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        """(G, W, C) worker outputs + (W,)/(G, W) availability ->
        (G*K, C) recovered predictions."""
        raise NotImplementedError

    def locate(self, outputs: torch.Tensor, avail: torch.Tensor
               ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
        """Locate-then-decode.  Returns ``(decoded, located, votes,
        masks)``, the last three (G, W) host arrays.  Without an error
        locator: the plain decode and empty verdicts (masks == avail)."""
        decoded = self.decode(outputs, avail)
        g, w = outputs.shape[:2]
        avail2d = np.broadcast_to(
            np.asarray(torch.as_tensor(avail).cpu(), np.float32), (g, w))
        return (decoded, np.zeros((g, w), bool), np.zeros((g, w), np.int32),
                avail2d.copy())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}({self.config})"


def _make_berrut(k: int, s: int = 1, e: int = 0, *, systematic: bool = False,
                 c_vote: int = 64) -> "BerrutScheme":
    return BerrutScheme(CodingConfig(k=k, s=s, e=e, systematic=systematic,
                                     c_vote=c_vote))


_REGISTRY: dict = {"berrut": _make_berrut}
# registered in the reference, waiting for their port
_NOT_PORTED = ("invnet", "nercc", "parm", "replication", "uncoded")


def scheme_names() -> Tuple[str, ...]:
    return tuple(sorted((*_REGISTRY, *_NOT_PORTED)))


def get_scheme(name: str, k: int, *, s: int = 1, e: int = 0,
               **kwargs) -> "RedundancyScheme":
    """Instantiate a scheme by name (``berrut``; ``systematic`` and
    ``c_vote`` pass through)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"scheme {name!r} is not ported yet "
                                  "(ROADMAP A8)")
    factory: Optional[Callable] = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown scheme {name!r}; registered schemes: "
                         f"{', '.join(scheme_names())}")
    return factory(k=k, s=s, e=e, **kwargs)


def as_scheme(obj) -> RedundancyScheme:
    """A ``RedundancyScheme`` passes through; a bare ``CodingConfig``
    wraps into ``BerrutScheme``."""
    if isinstance(obj, RedundancyScheme):
        return obj
    if isinstance(obj, CodingConfig):
        return BerrutScheme(obj)
    raise TypeError(f"expected RedundancyScheme or CodingConfig, got "
                    f"{type(obj).__name__}")


class BerrutScheme(RedundancyScheme):
    """ApproxIFER's Berrut rational-interpolation code (paper Eq. 4-11),
    wrapping ``CodingConfig``."""

    name = "berrut"

    def __init__(self, coding: CodingConfig):
        super().__init__(coding)
        self.coding = coding

    @property
    def has_locator(self) -> bool:
        return self.coding.e > 0

    def with_redundancy(self, *, s: Optional[int] = None,
                        e: Optional[int] = None) -> "BerrutScheme":
        s = self.s if s is None else s
        e = self.e if e is None else e
        if (s, e) == (self.s, self.e):
            return self
        # keep the knobs the registry does not carry (systematic, c_vote)
        return BerrutScheme(dataclasses.replace(self.coding, s=s, e=e))

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        return berrut_mod.encode(self.coding, grouped, axis=1)

    def decode(self, outputs: torch.Tensor, avail: torch.Tensor, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        return decode_coded_preds(self.coding, outputs, avail,
                                  locate=locate)

    def locate(self, outputs: torch.Tensor, avail: torch.Tensor):
        if self.coding.e == 0:
            return super().locate(outputs, avail)
        decoded, located, votes, masks = locate_and_decode(
            self.coding, outputs, avail)
        return (decoded, located.cpu().numpy(), votes.cpu().numpy(),
                masks.cpu().numpy())
