"""Berrut rational interpolation primitives (ApproxIFER Eq. 4-11).

Port of ``repro.core.berrut``.  K queries are encoded into N+1 coded
queries by Berrut's barycentric rational interpolant anchored at
Chebyshev points of the first kind and evaluated at Chebyshev points of
the second kind; decoding interpolates through the available coded
predictions back at the anchors.  Nodes and the static encode matrix are
built in float64 numpy exactly as the reference builds them; the
runtime (mask-dependent) decode matrix is built in float32 torch with
the reference's op order.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

# Tolerance for "evaluation point coincides with an interpolation node".
# Chebyshev 1st/2nd-kind grids can intersect (e.g. K=2, N=4: beta_1 == alpha_0),
# in which case the barycentric form has a removable singularity resolved
# exactly (the interpolant passes through the node value).
_NODE_HIT_TOL = 1e-6


def chebyshev_first_kind(k: int) -> np.ndarray:
    """alpha_j = cos((2j+1) pi / (2K)),  j = 0..K-1   (paper Eq. 6)."""
    if k < 1:
        raise ValueError(f"need K >= 1, got {k}")
    j = np.arange(k)
    return np.cos((2 * j + 1) * math.pi / (2 * k))


def chebyshev_second_kind(n: int) -> np.ndarray:
    """beta_i = cos(i pi / N),  i = 0..N   (paper Eq. 8; N+1 points)."""
    if n < 1:
        # Degenerate single-point grid (K=1, S=0): a single node at 1.0.
        return np.ones((1,))
    i = np.arange(n + 1)
    return np.cos(i * math.pi / n)


def berrut_weights(n_nodes: int) -> np.ndarray:
    """Berrut's weights w_i = (-1)^i (paper Eq. 2/5/10)."""
    return (-1.0) ** np.arange(n_nodes)


def basis_matrix(eval_points: torch.Tensor, nodes: torch.Tensor,
                 weights: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """float32 barycentric basis matrix L with L[m, i] = l_i(z_m).

    l_i(z) = (w_i * mask_i / (z - x_i)) / sum_k (w_k * mask_k / (z - x_k))

    Removable singularities (z_m == x_i) resolve to the exact one-hot
    row; a masked-out node is never "hit", its value being unavailable.
    """
    z = eval_points.to(torch.float32)
    x = nodes.to(torch.float32)
    w = weights.to(torch.float32)
    if mask is not None:
        w = w * mask.to(torch.float32)
    diff = z[:, None] - x[None, :]                       # (M, I)
    raw_hit = diff.abs() < _NODE_HIT_TOL
    # ``safe`` avoids the zero denominator even when the colliding node is
    # masked out (its weight is 0, but 0 * inf = nan).
    safe = torch.where(raw_hit, torch.ones_like(diff), diff)
    hit = raw_hit
    if mask is not None:
        hit = raw_hit & (mask != 0)[None, :]
    terms = w[None, :] / safe
    basis = terms / terms.sum(-1, keepdim=True)
    row_hit = hit.any(-1, keepdim=True)
    return torch.where(row_hit, hit.to(torch.float32), basis)


@dataclasses.dataclass(frozen=True)
class CodingConfig:
    """ApproxIFER redundancy parameters.

    K: queries per group.  S: stragglers tolerated.  E: Byzantine workers
    tolerated.  N+1 workers with N = K+S-1 (E=0) or N = 2(K+E)+S-1 (E>0)
    (paper Eq. 3/18).  ``systematic`` picks evaluation nodes that contain
    the K anchors, so the first K workers receive the real queries.
    ``c_vote`` is the number of strided logit coordinates the locator's
    majority vote uses.
    """

    k: int
    s: int = 1
    e: int = 0
    systematic: bool = False
    c_vote: int = 64

    def __post_init__(self):
        if self.k < 1 or self.s < 0 or self.e < 0:
            raise ValueError(f"invalid coding config {self}")

    @property
    def n(self) -> int:
        """Largest node index; N+1 nodes/workers total."""
        if self.e == 0:
            return self.k + self.s - 1
        return 2 * (self.k + self.e) + self.s - 1

    @property
    def num_workers(self) -> int:
        return self.n + 1

    @property
    def wait_for(self) -> int:
        """How many coded predictions the decoder waits for (paper §3)."""
        if self.e == 0:
            return self.k
        return 2 * (self.k + self.e)

    @property
    def decode_quorum(self) -> int:
        """K+2E responses determine the error-locator system (K with E=0)."""
        if self.e == 0:
            return self.k
        return min(self.k + 2 * self.e, self.num_workers)

    @property
    def overhead(self) -> float:
        """workers / queries (paper's resource-overhead metric)."""
        return self.num_workers / self.k

    @property
    def alphas(self) -> np.ndarray:
        return chebyshev_first_kind(self.k)

    @property
    def betas(self) -> np.ndarray:
        if not self.systematic:
            return chebyshev_second_kind(self.n)
        return _systematic_nodes(self.k, self.num_workers)


@functools.lru_cache(maxsize=None)
def _systematic_nodes(k: int, num_workers: int) -> np.ndarray:
    """All K anchors plus the (num_workers - K) Chebyshev-2nd-kind points
    farthest from any anchor, sorted descending (Berrut's alternating-sign
    hypothesis is about the SORTED node order)."""
    alphas = chebyshev_first_kind(k)
    extra_pool = chebyshev_second_kind(max(num_workers - 1, k + 1))
    need = num_workers - k
    nodes = list(alphas)
    for _ in range(need):
        dists = [min(abs(p - q) for q in nodes) for p in extra_pool]
        best = int(np.argmax(dists))
        nodes.append(float(extra_pool[best]))
        extra_pool = np.delete(extra_pool, best)
    order = np.argsort(-np.asarray(nodes), kind="stable")
    return np.asarray(nodes)[order]


@functools.lru_cache(maxsize=None)
def _encode_matrix_np(k: int, s: int, e: int,
                      systematic: bool = False) -> np.ndarray:
    """Static (N+1, K) encode matrix  W[i, j] = l_j(beta_i)  (Eq. 4-8),
    built in float64 and rounded once to float32."""
    cfg = CodingConfig(k=k, s=s, e=e, systematic=systematic)
    z = np.asarray(cfg.betas, np.float64)[:, None]
    x = np.asarray(cfg.alphas, np.float64)[None, :]
    w = np.asarray(berrut_weights(k), np.float64)[None, :]
    diff = z - x
    hit = np.abs(diff) < _NODE_HIT_TOL
    safe = np.where(hit, 1.0, diff)
    terms = w / safe
    basis = terms / terms.sum(-1, keepdims=True)
    row_hit = hit.any(-1, keepdims=True)
    out = np.where(row_hit, hit.astype(np.float64), basis).astype(np.float32)
    out.flags.writeable = False        # shared by every caller of the cache
    return out


def encode_matrix(cfg: CodingConfig, device=None) -> torch.Tensor:
    """(N+1, K) float32 encode matrix on ``device``, built once per
    (config, device) and shared (see ``nodes``): never write to it."""
    return _on_device(cfg, _device(device))[0]


def nodes(cfg: CodingConfig, device=None) -> tuple:
    """(alphas (K,), betas (N+1,)) as float32 tensors on ``device``,
    built once per (config, device) and shared: never write to them.

    A serving round reads them without copying from the host: a copy
    from pageable host memory synchronises the stream, so the host would
    wait for the round's model pass before it could queue the tail."""
    return _on_device(cfg, _device(device))[1:]


def _device(device) -> torch.device:
    return torch.device("cpu") if device is None else torch.device(device)


@functools.lru_cache(maxsize=None)
def _on_device(cfg: CodingConfig, device: torch.device) -> tuple:
    """(encode matrix, alphas, betas) of ``cfg`` on ``device``."""
    return (torch.tensor(_encode_matrix_np(cfg.k, cfg.s, cfg.e,
                                           cfg.systematic), device=device),
            torch.tensor(cfg.alphas, dtype=torch.float32, device=device),
            torch.tensor(cfg.betas, dtype=torch.float32, device=device))


def survivor_weights(mask: torch.Tensor) -> torch.Tensor:
    """Alternating Berrut weights over the *surviving* node set.

    w_i = (-1)^(rank of i among survivors), zero on masked-out nodes: the
    reference's documented deviation from the paper's original-index
    signs, which void Berrut's no-pole guarantee when an interior worker
    fails.  ``torch.remainder`` is the floored modulo of ``jnp.mod``.
    """
    m = mask.to(torch.float32)
    rank = torch.cumsum(m, -1) - 1.0
    sign = 1.0 - 2.0 * torch.remainder(rank, 2.0)
    return sign * m


def decode_matrix(cfg: CodingConfig, mask: torch.Tensor) -> torch.Tensor:
    """Runtime (K, N+1) float32 decode matrix for an availability ``mask``.

    The mask reaches ``basis_matrix`` explicitly so exact node hits on
    unavailable nodes fall back to interpolation.
    """
    return basis_matrix(*nodes(cfg, mask.device), survivor_weights(mask),
                        mask=mask)


def encode(cfg: CodingConfig, queries: torch.Tensor,
           axis: int = 0) -> torch.Tensor:
    """Encode K queries into N+1 coded queries along ``axis`` (Eq. 7):
    (..., K, ...) -> (..., N+1, ...)."""
    w = encode_matrix(cfg, device=queries.device).to(queries.dtype)
    coded = torch.tensordot(w, torch.movedim(queries, axis, 0),
                            dims=([1], [0]))
    return torch.movedim(coded, 0, axis)


def decode(cfg: CodingConfig, coded_preds: torch.Tensor, mask,
           axis: int = 0) -> torch.Tensor:
    """Recover K approximate predictions from masked coded predictions
    (Eq. 10-11): (..., N+1, ...) -> (..., K, ...)."""
    mask = torch.as_tensor(mask, dtype=torch.float32,
                           device=coded_preds.device)
    w = decode_matrix(cfg, mask).to(coded_preds.dtype)
    decoded = torch.tensordot(w, torch.movedim(coded_preds, axis, 0),
                              dims=([1], [0]))
    return torch.movedim(decoded, 0, axis)
