"""Redundancy schemes behind one protocol (port of ``repro.core.scheme``:
the fields the serving stack reads, and the Berrut scheme only).

The serving stack reads a scheme's static parameters (K, S, E, worker
width, wait-for, decode quorum, whether it has a locator), re-plans it
at another (S, E) with ``with_redundancy``, and wraps a bare
``CodingConfig`` with ``as_scheme``.  The lifecycle methods (``plan``,
``encode``, ``decode``, ``locate``) wait for the scheme-generic
``EngineExecutor`` (ROADMAP A5).  ``get_scheme("berrut")`` works; the
reference's other registered schemes are named here so that asking for
one says it is not ported yet, rather than unknown.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from repro_torch.core.berrut import CodingConfig


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
    def has_locator(self) -> bool:
        """Whether the scheme has an error locator (E > 0 for Berrut)."""
        return False

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
