"""ApproxIFER coded-inference engine (paper §3, Fig. 4); port of
``repro.core.engine``.

Fixed-shape and mask-driven: one code path handles any straggler or
Byzantine pattern.  The reference draws Byzantine noise with
``jax.random`` inside ``apply_byzantine``; here the caller passes the
noise tensor in, as the coded serving steps take it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import berrut
from repro_torch.core.berrut import CodingConfig
from repro_torch.core.error_locator import gather_vote_values, locate_groups


@dataclasses.dataclass(frozen=True)
class CodedBatch:
    """Bookkeeping for a coded forward: (groups, N+1) coded streams."""

    groups: int
    cfg: CodingConfig

    @property
    def coded_batch_size(self) -> int:
        return self.groups * self.cfg.num_workers


def group_queries(queries: torch.Tensor, k: int) -> torch.Tensor:
    """(B, ...) -> (B//K, K, ...).  B must be divisible by K."""
    b = queries.shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by K={k}")
    return queries.reshape(b // k, k, *queries.shape[1:])


def ungroup(preds: torch.Tensor) -> torch.Tensor:
    """(G, K, ...) -> (G*K, ...)."""
    return preds.reshape(-1, *preds.shape[2:])


def encode_groups(cfg: CodingConfig, grouped: torch.Tensor) -> torch.Tensor:
    """(G, K, ...) -> (G, N+1, ...)   (paper Eq. 7, batched over groups)."""
    return berrut.encode(cfg, grouped, axis=1)


def decode_groups(cfg: CodingConfig, coded_preds: torch.Tensor,
                  avail_mask) -> torch.Tensor:
    """(G, N+1, ...) + (N+1,) mask -> (G, K, ...)   (paper Eq. 10-11)."""
    return berrut.decode(cfg, coded_preds, avail_mask, axis=1)


def apply_byzantine(coded_preds: torch.Tensor,
                    byz_mask: Optional[torch.Tensor],
                    noise: Optional[torch.Tensor],
                    sigma: float) -> torch.Tensor:
    """Corrupt the coded predictions of Byzantine workers with
    ``sigma * noise`` (paper §4.2); noise has coded_preds' shape."""
    if byz_mask is None or noise is None:
        return coded_preds
    shape = [1] * coded_preds.ndim
    shape[1] = coded_preds.shape[1]
    m = torch.as_tensor(byz_mask, device=coded_preds.device).to(
        coded_preds.dtype).reshape(shape)
    return coded_preds + m * (sigma * noise.to(coded_preds.dtype))


def locate_and_decode(cfg: CodingConfig, preds: torch.Tensor,
                      avail: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Locate -> exclude -> decode over all groups (Alg. 1-3).

    The vote coordinates are gathered before the float32 upcast, the
    batched locator gates its verdicts on a vote majority, and each group
    is Berrut-decoded with its own exclusion mask.

    preds: (G, N+1, ...) coded predictions; avail: (N+1,) or (G, N+1).
    Returns decoded (G*K, ...), located (G, N+1) bool, votes (G, N+1)
    int32 and the per-group decode masks (G, N+1).
    """
    g = preds.shape[0]
    avail = torch.as_tensor(avail, dtype=torch.float32, device=preds.device)
    vals = gather_vote_values(preds.reshape(g, cfg.num_workers, -1),
                              cfg.c_vote)
    _, betas = berrut.nodes(cfg, preds.device)
    located, votes = locate_groups(betas, vals, avail, k=cfg.k, e=cfg.e)
    avail2d = avail.expand(g, cfg.num_workers)
    masks = avail2d.to(preds.dtype) * (1.0 - located.to(preds.dtype))
    decoded = torch.stack([berrut.decode(cfg, p, m, axis=0)
                           for p, m in zip(preds, masks)])
    return ungroup(decoded), located, votes, masks


def decode_coded_preds(cfg: CodingConfig, preds: torch.Tensor,
                       avail: torch.Tensor, *,
                       locate: Optional[bool] = None) -> torch.Tensor:
    """(G, N+1, ...) coded predictions + (N+1,) mask -> (G*K, ...).

    With E > 0 the locator runs and vote-confirmed Byzantine workers are
    excluded; ``locate=False`` forces the plain masked decode.
    """
    if locate is None:
        locate = cfg.e > 0
    if locate and cfg.e > 0:
        decoded, _, _, _ = locate_and_decode(cfg, preds, avail)
        return decoded
    return ungroup(decode_groups(cfg, preds, avail))


def mask_from_completion_times(
    cfg, times: np.ndarray,
    wait_for: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Derive the straggler mask from the event clock (DESIGN.md §8).

    The decode fires the moment the fastest ``wait_for`` coded workers
    have landed; every slower worker is a straggler for this round.
    ``cfg`` is anything exposing the default ``wait_for``.  ``times`` is
    (..., N+1).  Returns the (..., N+1) float32 mask with exactly
    ``wait_for`` ones per row (a stable argsort breaks ties) and the
    (...,) trigger time of the wait_for-th worker.
    """
    t = np.asarray(times, np.float64)
    w = cfg.wait_for if wait_for is None else wait_for
    if not 1 <= w <= t.shape[-1]:
        raise ValueError(f"wait_for={w} out of range for {t.shape[-1]} "
                         "workers")
    order = np.argsort(t, axis=-1, kind="stable")
    mask = np.zeros(t.shape, np.float32)
    np.put_along_axis(mask, order[..., :w], 1.0, axis=-1)
    trigger = np.take_along_axis(t, order[..., w - 1:w], axis=-1)[..., 0]
    return mask, trigger


def coded_inference(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: CodingConfig,
    queries: torch.Tensor,
    *,
    straggler_mask: Optional[torch.Tensor] = None,
    completion_times: Optional[np.ndarray] = None,
    byz_mask: Optional[torch.Tensor] = None,
    byz_noise: Optional[torch.Tensor] = None,
    byz_sigma: float = 10.0,
    locate: Optional[bool] = None,
) -> torch.Tensor:
    """End-to-end ApproxIFER pipeline (Fig. 4): encode the (B, ...)
    queries in groups of K, run ``predict_fn`` on every coded stream,
    corrupt the Byzantine workers' predictions by ``byz_sigma *
    byz_noise`` ((G, N+1, C...) noise), and decode under the straggler
    mask (given, or derived from ``completion_times``; default all
    available).  Returns the (B, C...) approximate predictions.
    """
    grouped = group_queries(queries, cfg.k)           # (G, K, ...)
    coded = encode_groups(cfg, grouped)               # (G, N+1, ...)
    flat = coded.reshape(-1, *coded.shape[2:])        # (G*(N+1), ...)
    preds = predict_fn(flat)
    preds = preds.reshape(coded.shape[0], cfg.num_workers, *preds.shape[1:])
    preds = apply_byzantine(preds, byz_mask, byz_noise, byz_sigma)
    if straggler_mask is None and completion_times is not None:
        derived, _ = mask_from_completion_times(cfg, completion_times)
        straggler_mask = derived
    if straggler_mask is None:
        straggler_mask = torch.ones((cfg.num_workers,))
    straggler_mask = torch.as_tensor(straggler_mask, device=preds.device).to(
        preds.dtype)
    return decode_coded_preds(cfg, preds, straggler_mask, locate=locate)


class ApproxIFEREngine:
    """Object wrapper used by the serving runtime and examples."""

    def __init__(self, predict_fn, cfg: CodingConfig):
        self.predict_fn = predict_fn
        self.cfg = cfg

    def __call__(self, queries, **kw):
        return coded_inference(self.predict_fn, self.cfg, queries, **kw)

    def encode(self, queries):
        return encode_groups(self.cfg, group_queries(queries, self.cfg.k))

    def decode(self, coded_preds, mask):
        # through the one decode path, so the locator runs when E > 0
        return decode_coded_preds(self.cfg, coded_preds, mask)
