"""ParM baseline (Kosaian et al., SOSP'19); port of ``repro.core.parity``.

ParM encodes K queries into one parity query (their sum), feeds it to a
learned parity model f_P trained so that

    f_P(X_0 + ... + X_{K-1})  ~  f(X_0) + ... + f(X_{K-1}),

and reconstructs one missing prediction as
    \\hat Y_m = f_P(sum X) - sum_{j != m} f(X_j).

It tolerates S=1 straggler per group and must be retrained per hosted
model, the scaling limit ApproxIFER removes.  Training f_P is not here:
``parity_distillation_loss`` is its objective, a plain function.
"""

from __future__ import annotations

from typing import Callable

import torch


def parity_query(grouped_queries: torch.Tensor) -> torch.Tensor:
    """(G, K, ...) -> (G, ...): the ParM linear code (sum of the group)."""
    return grouped_queries.sum(1)


def parity_target(grouped_preds: torch.Tensor) -> torch.Tensor:
    """(G, K, C) -> (G, C): the ideal parity output sum_j f(X_j)."""
    return grouped_preds.sum(1)


def parity_distillation_loss(
    parity_apply: Callable[..., torch.Tensor],
    parity_params,
    grouped_queries: torch.Tensor,
    grouped_base_preds: torch.Tensor,
) -> torch.Tensor:
    """MSE distillation objective used to train f_P (ParM §4)."""
    pred = parity_apply(parity_params, parity_query(grouped_queries))
    return ((pred - parity_target(grouped_base_preds)) ** 2).mean()


def parm_inference(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    parity_fn: Callable[[torch.Tensor], torch.Tensor],
    queries: torch.Tensor,
    k: int,
    *,
    straggler=0,
) -> torch.Tensor:
    """ParM pipeline: K data workers + 1 parity worker per group, data
    worker ``straggler`` (an index in [0, K)) unavailable and its
    prediction reconstructed from the parity (Appendix C's worst case).

    queries: (B, ...), B divisible by K.  Returns (B, C).
    """
    g = queries.shape[0] // k
    grouped = queries.reshape(g, k, *queries.shape[1:])
    base = predict_fn(queries).reshape(g, k, -1)
    parity = parity_fn(parity_query(grouped))            # (G, C)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(straggler, device=base.device), k).to(base.dtype)
    # reconstruction: parity - sum of the surviving predictions
    survivors = torch.einsum("gkc,k->gc", base, 1.0 - onehot)
    recon = parity - survivors
    out = (base * (1.0 - onehot)[None, :, None]
           + recon[:, None, :] * onehot[None, :, None])
    return out.reshape(g * k, -1)
