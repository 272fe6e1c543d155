"""BW-type rational error locator (ApproxIFER Algorithms 1-3, Appendix A).

Port of ``repro.core.error_locator``.  Given possibly-corrupted
evaluations y_i ~ r(beta_i) of a (K-1, K-1)-degree rational function,
find P = p*Lambda, Q = q*Lambda of degree K+E-1 with P(beta_i) = y_i
Q(beta_i) on available nodes; Lambda vanishes at corrupted nodes, so the
E available nodes with the smallest |Q(beta_i)| are declared Byzantine
(Algorithm 1).  Algorithm 2 repeats this per logit coordinate and
majority-votes.

Where the reference ``vmap``s over groups and coordinates, this port
carries them as leading batch dimensions: every function takes
``(..., N+1)`` values and ``(..., N+1)`` masks that broadcast together.
The system is solved in the Chebyshev basis by the reference's blocked
ridge normal equations (Cholesky of the P block, LU of the Schur
complement, one refinement step).  Ties in every top-E pick break to the
lower index, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_RIDGE = 1e-7


def chebyshev_design(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Design matrix T[..., i, m] = T_m(x_i), m = 0..degree."""
    cols = [torch.ones_like(x)]
    if degree >= 1:
        cols.append(x)
    for _ in range(2, degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return torch.stack(cols, dim=-1)


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (a @ x.unsqueeze(-1)).squeeze(-1)


def solve_pq(betas: torch.Tensor, y: torch.Tensor, avail_mask: torch.Tensor,
             k: int, e: int):
    """Solve  P(beta_i) = y_i * Q(beta_i)  with Q normalised to Q_0 = 1.

    y: (..., N+1); avail_mask broadcastable to it.  Returns (p_coef,
    q_coef) in the Chebyshev basis, (..., K+E) each; q_coef includes the
    pinned leading 1.  The P block ``A11 = T^T m T`` depends only on the
    mask, so with a mask shared across coordinates its Cholesky factor is
    computed once per mask.
    """
    deg = k + e - 1                       # polynomials have K+E coefficients
    t = chebyshev_design(betas.to(y.dtype), deg)          # (N+1, K+E)
    mask = avail_mask.to(y.dtype)
    # Scale-normalise the values so the ridge term is meaningful for any
    # logit magnitude.
    scale = (y.abs() * mask).amax(-1, keepdim=True) + 1e-12
    ys = y / scale
    t1 = t[:, 1:]
    m2 = mask * mask
    w1 = m2 * ys
    w2 = w1 * ys
    eye1 = torch.eye(deg + 1, dtype=t.dtype, device=t.device)
    a11 = (t * m2.unsqueeze(-1)).mT @ t + _RIDGE * eye1
    r1 = w1 @ t
    if deg == 0:                          # K = 1, E = 0: Q is the pinned 1
        a11 = a11.expand(*r1.shape[:-1], 1, 1)
        p = torch.linalg.solve(a11, r1)
        return p * scale, torch.ones_like(p)
    a12 = -((t * w1.unsqueeze(-1)).mT @ t1)
    a22 = ((t1 * w2.unsqueeze(-1)).mT @ t1
           + _RIDGE * torch.eye(deg, dtype=t.dtype, device=t.device))
    r2 = -(w2 @ t1)
    c11 = torch.linalg.cholesky_ex(a11).L
    c11 = c11.expand(*a12.shape[:-2], *c11.shape[-2:])
    # one multi-rhs triangular solve covers A11^-1 [A12 | r1]
    x = torch.cholesky_solve(torch.cat([a12, r1.unsqueeze(-1)], -1), c11)
    x12, x1 = x[..., :-1], x[..., -1]                     # A11^-1 A12/r1
    schur = a22 - a12.mT @ x12
    lu, piv, _ = torch.linalg.lu_factor_ex(schur)

    def block_solve(b1, b2, u1=None):
        if u1 is None:
            u1 = torch.cholesky_solve(b1.unsqueeze(-1), c11).squeeze(-1)
        q = torch.linalg.lu_solve(
            lu, piv, (b2 - _mv(a12.mT, u1)).unsqueeze(-1)).squeeze(-1)
        return u1 - _mv(x12, q), q

    p, q_tail = block_solve(r1, r2, u1=x1)
    # One step of iterative refinement through the reusable block
    # factorisation recovers the residual accuracy of a full pivoted LU.
    res1 = r1 - (_mv(a11, p) + _mv(a12, q_tail))
    res2 = r2 - (_mv(a12.mT, p) + _mv(a22, q_tail))
    dp, dq = block_solve(res1, res2)
    p, q_tail = p + dp, q_tail + dq
    q_coef = torch.cat([torch.ones_like(q_tail[..., :1]), q_tail], -1)
    return p * scale, q_coef


def q_magnitudes(betas: torch.Tensor, y: torch.Tensor,
                 avail_mask: torch.Tensor, k: int, e: int) -> torch.Tensor:
    """|Q(beta_i)| per node, (..., N+1); small values mark error locations
    (Alg. 1 Step 3).  Unavailable nodes are pushed to the float maximum so
    they are never "located"."""
    _, q_coef = solve_pq(betas, y, avail_mask, k, e)
    t = chebyshev_design(betas.to(y.dtype), k + e - 1)
    qvals = _mv(t, q_coef).abs()
    big = torch.finfo(qvals.dtype).max
    return torch.where(avail_mask.bool(), qvals,
                       torch.full_like(qvals, big))


def rational_eval(x: torch.Tensor, p_coef: torch.Tensor,
                  q_coef: torch.Tensor) -> torch.Tensor:
    """Evaluate r(x) = P(x)/Q(x) (Algorithm 3 Step 2) in the Chebyshev basis."""
    t = chebyshev_design(x, p_coef.shape[-1] - 1)
    return (t @ p_coef) / (t @ q_coef)


def _top_indices(values: torch.Tensor, count: int,
                 largest: bool) -> torch.Tensor:
    """Indices of the ``count`` largest (or smallest) entries along the last
    axis, ties to the lower index (``jax.lax.top_k``'s order)."""
    order = torch.sort(values, dim=-1, descending=largest, stable=True)[1]
    return order[..., :count]


def vote_errors(betas: torch.Tensor, coded_values: torch.Tensor,
                avail_mask: torch.Tensor, *, k: int, e: int) -> torch.Tensor:
    """Algorithm 2 vote tally: per-worker count of per-coordinate locations.

    coded_values: (..., N+1, C_vote); avail_mask: (..., N+1).  Each of the
    C_vote coordinates votes for the E workers with the smallest
    |Q(beta_i)|.  Returns (..., N+1) int32 votes, unavailable workers
    pinned to -1.
    """
    n_nodes = coded_values.shape[-2]
    if e == 0:
        return torch.zeros(coded_values.shape[:-1], dtype=torch.int32,
                           device=coded_values.device)
    y = coded_values.transpose(-1, -2)                    # (..., C, N+1)
    scores = q_magnitudes(betas, y, avail_mask.unsqueeze(-2), k, e)
    locs = _top_indices(scores, e, largest=False)         # (..., C, E)
    hits = torch.nn.functional.one_hot(locs, n_nodes)     # (..., C, E, N+1)
    votes = hits.sum(dim=(-3, -2)).to(torch.int32)
    return torch.where(avail_mask.bool(), votes, torch.full_like(votes, -1))


def locate_errors(betas: torch.Tensor, coded_values: torch.Tensor,
                  avail_mask: torch.Tensor, *, k: int,
                  e: int) -> torch.Tensor:
    """Algorithm 2 for one group, ungated: (N+1,) bool with exactly ``e``
    located workers (all False when e == 0).  coded_values: (N+1, C)."""
    n_nodes = betas.shape[0]
    located = torch.zeros((n_nodes,), dtype=torch.bool,
                          device=coded_values.device)
    if e == 0:
        return located
    votes = vote_errors(betas, coded_values, avail_mask, k=k, e=e)
    return located.index_fill_(0, _top_indices(votes, e, largest=True), True)


def locate_groups(betas: torch.Tensor, grouped_values: torch.Tensor,
                  avail_mask: torch.Tensor, *, k: int, e: int):
    """Batched, vote-gated Algorithm 2 over query groups.

    A worker is located only if it is in the top-E of the votes pooled
    across groups AND a strict majority of all vote coordinates agree;
    the pooled verdict applies to every group where the worker is
    available.

    grouped_values: (G, N+1, C_vote); avail_mask: (N+1,) or (G, N+1).
    Returns located (G, N+1) bool and the raw per-group votes (G, N+1)
    int32 (unavailable workers pinned to -1).
    """
    g, n_nodes = grouped_values.shape[0], betas.shape[0]
    dev = grouped_values.device
    if e == 0:
        return (torch.zeros((g, n_nodes), dtype=torch.bool, device=dev),
                torch.zeros((g, n_nodes), dtype=torch.int32, device=dev))
    if avail_mask.dim() == 1:
        avail_mask = avail_mask.expand(g, n_nodes)
    c_used = grouped_values.shape[-1]
    votes = vote_errors(betas, grouped_values, avail_mask, k=k, e=e)
    avail = avail_mask.bool()
    pooled = votes.clamp(min=0).sum(0)                    # (N+1,)
    # never locate a worker that is unavailable in EVERY group
    pooled = torch.where(avail.any(0), pooled, torch.full_like(pooled, -1))
    # index_fill_ takes the value as a scalar: an indexed assignment would
    # copy it from the host, which blocks until the stream has drained
    top_mask = torch.zeros((n_nodes,), dtype=torch.bool,
                           device=dev).index_fill_(
                               0, _top_indices(pooled, e, largest=True), True)
    confident = pooled * 2 > g * c_used       # strict majority of coords
    located = (top_mask & confident)[None, :] & avail
    return located, votes


@dataclass(frozen=True)
class ExactTally:
    """One ``locate_groups`` call's pooled verdict read in fp64.

    ``tally``: the fp64 pooled votes per worker; ``moved``: how many of
    the G*C per-coordinate picks (each the E workers of smallest |Q|)
    fp32 arithmetic moves on the same columns; ``threshold``: the strict
    majority a tally must exceed; ``located``: the fp64 verdict.
    """
    tally: tuple
    moved: int
    threshold: float
    located: frozenset

    def near_tie(self, worker: int) -> bool:
        """True when the picks fp32 moves can carry the worker's exact
        tally across the threshold, so that fp32 inputs do not fix its
        verdict.  A moved pick shifts a tally by at most one, and a
        worker is located iff its tally exceeds the threshold: a located
        worker's verdict flips once ``margin`` picks move, an unlocated
        one's once more than ``-margin`` do."""
        margin = self.tally[worker] - self.threshold
        return self.moved >= margin if margin > 0 else self.moved > -margin

    def explains(self, worker: int, located: bool) -> bool:
        """A verdict is explained when it is the exact one or a near tie."""
        return located == (worker in self.located) or self.near_tie(worker)


def exact_tally(coding, vals: torch.Tensor,
                avail: torch.Tensor) -> ExactTally:
    """``locate_groups``'s pooled verdict on (G, N+1, C) vote columns and
    (N+1,) or (G, N+1) availability, recomputed on the host in fp64 and
    in fp32 (the verdicts at the bare K+2E quorum are often near ties).
    ``coding``: a ``CodingConfig`` (its betas, K and E)."""
    g, n1, c = vals.shape
    vals = vals.detach().cpu()
    avail = avail.detach().cpu().expand(g, n1).double()
    picks = {}
    for dt in (torch.float32, torch.float64):
        q = q_magnitudes(torch.tensor(coding.betas, dtype=dt),
                         vals.to(dt).mT, avail.to(dt).unsqueeze(-2),
                         coding.k, coding.e)
        picks[dt] = _top_indices(q, coding.e, largest=False).sort(-1)[0]
    tally = torch.nn.functional.one_hot(picks[torch.float64], n1).sum(
        (0, 1, 2)).tolist()
    moved = int((picks[torch.float32] != picks[torch.float64]).any(-1).sum())
    threshold = g * c / 2
    top = sorted(range(n1), key=lambda w: (-tally[w], w))[:coding.e]
    return ExactTally(tuple(tally), moved, threshold,
                      frozenset(w for w in top if tally[w] > threshold))


def vote_layout(num_classes: int, c_vote: int) -> tuple[int, int]:
    """(count, stride) of the vote-coordinate subset: coordinates are
    ``arange(count) * stride``, the single definition every locate path
    and the fused decode kernel's gather share."""
    c = min(num_classes, c_vote)
    return c, max(num_classes // c, 1)


def gather_vote_values(grouped: torch.Tensor, c_vote: int) -> torch.Tensor:
    """(..., N+1, C_total) -> (..., N+1, C_vote) float32 vote columns,
    gathered from the raw block before the upcast (a strided view, so only
    the gathered slice is ever cast)."""
    c, stride = vote_layout(grouped.shape[-1], c_vote)
    return grouped[..., : c * stride : stride].to(torch.float32)


def vote_coordinates(num_classes: int, c_vote: int,
                     device=None) -> torch.Tensor:
    """The strided logit coordinates of the majority vote (``vote_layout``)."""
    c, stride = vote_layout(num_classes, c_vote)
    return torch.arange(c, device=device) * stride


def locate_errors_from_logits(cfg, betas: torch.Tensor,
                              coded_logits: torch.Tensor,
                              avail_mask: torch.Tensor) -> torch.Tensor:
    """Vote-gated Algorithm 2 for one group from its full logits.

    coded_logits: (N+1, C) or (N+1, ..., C); the extra axes fold into the
    vote set (every (position, class) pair is one coordinate).  ``cfg``: a
    ``CodingConfig`` (its K, E and c_vote).  Returns (N+1,) bool: on clean
    data nobody is located (unlike ``locate_errors``, which always flags
    E workers).
    """
    flat = coded_logits.reshape(1, coded_logits.shape[0], -1)
    coords = vote_coordinates(flat.shape[-1], cfg.c_vote, flat.device)
    located, _ = locate_groups(betas, flat[:, :, coords], avail_mask,
                               k=cfg.k, e=cfg.e)
    return located[0]
