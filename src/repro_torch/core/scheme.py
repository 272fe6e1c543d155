"""Redundancy schemes behind one protocol (port of ``repro.core.scheme``).

A scheme has static parameters (K, S, E, worker width, wait-for, decode
quorum, whether it has a locator), re-plans at another (S, E) with
``with_redundancy``, and serves one batch through the lifecycle

    plan(groups)      -> DispatchPlan (worker-pool width, wait-for quorum)
    encode(grouped)   -> per-worker payloads     (G, K, ...) -> (G, W, ...)
    forward(f, coded) -> worker outputs          (G, W, ...) -> (G, W, C)
    decode(outputs, avail)  -> recovered predictions          (G*K, C)
    locate(outputs, avail)  -> decoded + locator verdicts / votes / masks

that the event loop and ``EngineExecutor`` are written against.
``as_scheme`` wraps a bare ``CodingConfig``.  Schemes register under a
name (``register_scheme``): berrut, uncoded, replication and parm here,
nercc and invnet in their own modules, which the foot of this one
imports so that every name is registered whatever the caller imported
first.  Worker i owns stream i of every group of a batch, so
availability masks are (W,) over the worker pool, or (G, W).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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

    def with_redundancy(self, *, s: Optional[int] = None,
                        e: Optional[int] = None) -> "RedundancyScheme":
        """This scheme at another (S, E); K never changes.  Rebuilt
        through the registry; schemes with constructor state the registry
        does not carry override this to keep it."""
        s = self.s if s is None else s
        e = self.e if e is None else e
        if (s, e) == (self.s, self.e):
            return self
        return get_scheme(self.name, self.k, s=s, e=e)

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


_REGISTRY: Dict[str, Callable[..., RedundancyScheme]] = {}
_DESCRIPTIONS: Dict[str, str] = {}


def register_scheme(name: str, description: str = ""):
    """Class/factory decorator adding a scheme to the string registry;
    ``description`` (default: the factory's first docstring line) is the
    one-line summary ``list_schemes`` gives."""
    def deco(factory):
        _REGISTRY[name] = factory
        _DESCRIPTIONS[name] = (description
                               or (factory.__doc__ or "").strip().split(
                                   "\n")[0])
        return factory
    return deco


def scheme_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def list_schemes() -> Dict[str, str]:
    """Every registered scheme: sorted ``{name: one-line description}``."""
    return {name: _DESCRIPTIONS.get(name, "") for name in scheme_names()}


def get_scheme(name: str, k: int, *, s: int = 1, e: int = 0,
               **kwargs) -> "RedundancyScheme":
    """Instantiate a registered scheme by name.  K, S and E are uniform;
    scheme-specific extras pass through (``systematic`` / ``c_vote`` for
    berrut, ``parity_fn`` for parm and invnet, the regression knobs of
    nercc, the flow of invnet)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}; registered schemes: "
                         f"{', '.join(scheme_names())}") from None
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


@register_scheme("berrut", description="ApproxIFER Berrut rational code "
                 "(paper Eq. 4-11): model-agnostic, vote-gated locator, "
                 "optional systematic nodes")
def _make_berrut(k: int, s: int = 1, e: int = 0, *, systematic: bool = False,
                 c_vote: int = 64) -> "BerrutScheme":
    return BerrutScheme(CodingConfig(k=k, s=s, e=e, systematic=systematic,
                                     c_vote=c_vote))


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


def _avail2d(avail, g: int, w: int, dtype, device) -> torch.Tensor:
    """(W,) or (G, W) availability as a (G, W) tensor."""
    return torch.as_tensor(avail, dtype=dtype, device=device).expand(g, w)


# ---------------------------------------------------------------- uncoded

@dataclasses.dataclass(frozen=True)
class UncodedConfig:
    """No redundancy: K queries on K workers, wait for all of them."""

    k: int
    s: int = 0
    e: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"need K >= 1, got {self.k}")

    @property
    def num_workers(self) -> int:
        return self.k

    @property
    def wait_for(self) -> int:
        return self.k

    @property
    def decode_quorum(self) -> int:
        return self.k


@register_scheme("uncoded", description="no redundancy: K queries on K "
                 "workers, waits for all, tolerates nothing (ground-truth "
                 "baseline)")
def _make_uncoded(k: int, s: int = 0, e: int = 0) -> "UncodedScheme":
    # S and E are accepted for the registry's sake: an uncoded system
    # tolerates neither
    return UncodedScheme(UncodedConfig(k=k))


class UncodedScheme(RedundancyScheme):
    """The no-redundancy baseline: each query is its own worker stream,
    the decoder waits for all K and recovers nothing."""

    name = "uncoded"

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        return grouped

    def decode(self, outputs: torch.Tensor, avail, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        # an unavailable slot answers zeros ("no response"), never an
        # output that has not landed (speculative decodes below wait_for)
        del locate
        g, w = outputs.shape[:2]
        extra = (1,) * (outputs.ndim - 2)
        out = outputs * _avail2d(avail, g, w, outputs.dtype,
                                 outputs.device).reshape(g, w, *extra)
        return out.reshape(-1, *outputs.shape[2:])


# ------------------------------------------------------------ replication

@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """(S+1)-replication for stragglers, (2E+1)-replication for Byzantine
    workers (paper §1/§5)."""

    k: int
    s: int = 1
    e: int = 0

    def __post_init__(self):
        if self.k < 1 or self.s < 0 or self.e < 0:
            raise ValueError(f"invalid replication config {self}")

    @property
    def replicas(self) -> int:
        return (self.s + 1) if self.e == 0 else (2 * self.e + 1)

    @property
    def num_workers(self) -> int:
        return self.k * self.replicas

    @property
    def wait_for(self) -> int:
        # stragglers: up to S missing workers in all (each query keeps one
        # of its S+1 replicas); the Byzantine median needs every replica
        if self.e == 0:
            return self.num_workers - self.s
        return self.num_workers

    @property
    def decode_quorum(self) -> int:
        return self.wait_for


@register_scheme("replication", description="(S+1)x / (2E+1)x replication "
                 "(paper §1/§5): exact but at the overhead coding exists "
                 "to avoid")
def _make_replication(k: int, s: int = 1, e: int = 0) -> "ReplicationScheme":
    return ReplicationScheme(ReplicationConfig(k=k, s=s, e=e))


class ReplicationScheme(RedundancyScheme):
    """Query q's replicas live on worker streams q*R .. q*R+R-1.  Straggler
    recovery takes the first available replica, Byzantine recovery the
    coordinate-wise median over the available ones."""

    name = "replication"

    @property
    def replicas(self) -> int:
        return self.config.replicas

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(grouped, self.replicas, dim=1)

    def decode(self, outputs: torch.Tensor, avail, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        from repro_torch.core.replication import recover_from_replicas
        del locate
        g, r = outputs.shape[0], self.replicas
        per = outputs.reshape(g * self.k, r, *outputs.shape[2:])
        am = _avail2d(avail, g, self.num_workers, torch.float32,
                      outputs.device)
        return recover_from_replicas(per, am.reshape(g * self.k, r), self.e)


# ------------------------------------------------------------------ parm

@dataclasses.dataclass(frozen=True)
class ParMConfig:
    """ParM (Kosaian et al., SOSP'19): K data workers + 1 learned-parity
    worker per group; tolerates exactly one unavailable data worker."""

    k: int
    s: int = 1
    e: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"need K >= 1, got {self.k}")
        if self.s != 1:
            raise ValueError(f"ParM tolerates exactly S=1 straggler per "
                             f"group, got s={self.s}")
        if self.e != 0:
            raise ValueError("ParM has no Byzantine recovery (e must "
                             f"be 0, got {self.e})")

    @property
    def num_workers(self) -> int:
        return self.k + 1

    @property
    def wait_for(self) -> int:
        return self.k

    @property
    def decode_quorum(self) -> int:
        return self.k


@register_scheme("parm", description="ParM learned-parity code (Kosaian "
                 "et al., SOSP'19): K data + 1 parity stream, exactly one "
                 "straggler, parity model per hosted model")
def _make_parm(k: int, s: int = 1, e: int = 0, *,
               parity_fn: Optional[Callable] = None) -> "ParMScheme":
    return ParMScheme(ParMConfig(k=k, s=s, e=e), parity_fn=parity_fn)


class ParMScheme(RedundancyScheme):
    """ParM: the parity query is the sum of the group, the parity worker
    runs the learned parity model f_P (f_P(sum X) ~ sum f(X)), and one
    missing data prediction is parity - sum(survivors).  Without
    ``parity_fn`` the parity stream runs the hosted model itself: exact
    for linear models only, ParM's need of a parity model per hosted
    model made visible."""

    name = "parm"

    def __init__(self, config: ParMConfig,
                 parity_fn: Optional[Callable] = None):
        super().__init__(config)
        self.parity_fn = parity_fn

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        return torch.cat([grouped, grouped.sum(1, keepdim=True)], dim=1)

    def forward(self, predict_fn, coded: torch.Tensor) -> torch.Tensor:
        k, g = self.k, coded.shape[0]
        data_preds = predict_fn(coded[:, :k].reshape(g * k,
                                                     *coded.shape[2:]))
        fp = self.parity_fn if self.parity_fn is not None else predict_fn
        parity_preds = fp(coded[:, k])
        data_preds = data_preds.reshape(g, k, *data_preds.shape[1:])
        return torch.cat([data_preds, parity_preds[:, None]], dim=1)

    def decode(self, outputs: torch.Tensor, avail, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        del locate
        k, g = self.k, outputs.shape[0]
        avail2d = _avail2d(avail, g, k + 1, outputs.dtype, outputs.device)
        extra = (1,) * (outputs.ndim - 2)
        ad = avail2d[:, :k].reshape(g, k, *extra)       # data availability
        ap = avail2d[:, k].reshape(g, *extra)           # parity's
        data, parity = outputs[:, :k], outputs[:, k]
        survivors = (data * ad).sum(1)
        recon = (parity - survivors)[:, None] * ap[:, None]
        out = data * ad + (1.0 - ad) * recon
        return out.reshape(g * k, *outputs.shape[2:])


# registered by importing them; they import this module
from repro_torch.core import invnet, nercc  # noqa: E402,F401
