"""Replication baselines (paper §1/§5); port of ``repro.core.replication``.

To tolerate S stragglers every query goes to S+1 workers ((S+1)K in
all); to tolerate E Byzantine workers to 2E+1 workers ((2E+1)K), whose
answers are combined by a coordinate-wise median.  ApproxIFER needs only
K+S or 2(K+E)+S workers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def replication_workers(k: int, s: int, e: int) -> int:
    """Worker count of the replication scheme (paper §1 claim 2)."""
    if e == 0:
        return (s + 1) * k
    return (2 * e + 1) * k


def nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median over ``dim`` ignoring NaNs, as ``jnp.nanmedian`` takes it:
    an even count answers the mean of its two middle values (linear
    interpolation at the 0.5 quantile), where ``torch.nanmedian`` would
    answer the lower one; an all-NaN slice answers NaN."""
    x = x.movedim(dim, -1)
    n = (~torch.isnan(x)).sum(-1, keepdim=True)
    ordered = torch.sort(x, dim=-1)[0]          # NaNs sort last
    pos = 0.5 * (n - 1).clamp_min(0).to(x.dtype)
    lo, hi = pos.floor(), pos.ceil()
    w_hi = pos - lo
    med = (torch.gather(ordered, -1, lo.long()) * (1.0 - w_hi)
           + torch.gather(ordered, -1, hi.long()) * w_hi)
    return torch.where(n > 0, med, torch.nan).squeeze(-1)


def recover_from_replicas(preds: torch.Tensor, mask, e: int) -> torch.Tensor:
    """Per-query replica recovery: (B, R, ...) preds + (R,)/(B, R) mask
    -> (B, ...).  With ``e == 0`` each query answers its first available
    replica; with ``e > 0`` the coordinate-wise median over the available
    replicas (robust to E < R/2 corruptions).  A query none of whose
    replicas is available answers zeros."""
    b, r = preds.shape[:2]
    mask = torch.as_tensor(mask, dtype=preds.dtype,
                           device=preds.device).expand(b, r)
    extra = (1,) * (preds.ndim - 2)
    avail = (mask > 0.5).reshape(b, r, *extra)
    if e > 0:
        med = nanmedian(torch.where(avail, preds, torch.nan), dim=1)
        return torch.where(torch.isnan(med), 0.0, med)
    # argmax takes the first of equal maxima: the first available replica
    first = torch.argmax((mask > 0.5).to(torch.int8), dim=1)
    picked = torch.gather(preds, 1, first.reshape(b, 1, *extra).expand(
        b, 1, *preds.shape[2:]))[:, 0]
    any_avail = (mask.amax(1) > 0.5).reshape(b, *extra)
    return torch.where(any_avail, picked, 0.0)


def replicated_inference(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    queries: torch.Tensor,
    *,
    s: int = 1,
    e: int = 0,
    straggler_mask=None,
    byz_mask=None,
    byz_noise: Optional[torch.Tensor] = None,
    byz_generator: Optional[torch.Generator] = None,
    byz_sigma: float = 10.0,
) -> torch.Tensor:
    """Replication pipeline with the engine's mask semantics.

    queries: (B, ...).  Each query goes to R = S+1 (or 2E+1) replicas;
    ``straggler_mask`` is (R,), one pattern for the batch, or (B, R).
    ``byz_mask`` (R,) marks the corrupted replicas, which add
    ``byz_sigma`` times standard normal noise: ``byz_noise`` (B, R, C)
    given by value, or drawn from ``byz_generator``.  Returns (B, C).
    """
    r = (s + 1) if e == 0 else (2 * e + 1)
    b = queries.shape[0]
    rep = queries[:, None].expand(b, r, *queries.shape[1:])
    preds = predict_fn(rep.reshape(b * r, *queries.shape[1:])).reshape(
        b, r, -1)
    if byz_mask is not None and (byz_noise is not None
                                 or byz_generator is not None):
        if byz_noise is None:
            byz_noise = torch.randn(preds.shape, generator=byz_generator,
                                    device=preds.device, dtype=preds.dtype)
        m = torch.as_tensor(byz_mask, dtype=preds.dtype, device=preds.device)
        preds = preds + m[None, :, None] * (byz_sigma * byz_noise.to(
            device=preds.device, dtype=preds.dtype))
    if straggler_mask is None:
        straggler_mask = torch.ones((r,), dtype=preds.dtype)
    return recover_from_replicas(preds, straggler_mask, e)
