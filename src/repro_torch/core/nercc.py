"""NeRCC: nested-regression coded inference (arXiv 2402.04377); port of
``repro.core.nercc``.

Two nested regression layers in place of ApproxIFER's rational
interpolation:

  * **layer 1 (encoder)**: fit a smoothing regression u(z) through the
    K real queries at the Chebyshev first-kind anchors and evaluate it
    at the W worker nodes; worker i computes f(u(beta_i));
  * **layer 2 (decoder)**: fit a smoothing regression through the
    available worker outputs at their nodes and evaluate it back at the
    anchors.

Both layers are ridge-regularised Chebyshev regressions (a diag(m^4)
roughness penalty, the Chebyshev counterpart of a smoothing spline's),
so they reduce to a static (W, K) encode matrix and a mask-dependent
(K, W) decode matrix.  Byzantine mode (E > 0) takes Berrut's geometry,
2(K+E)+S workers and a K+2E decode quorum, with a studentised-residual
locator: a worker whose residual is an outlier on a majority of the vote
coordinates pooled over the groups is excluded and the decoder refits
without it.

Where the reference ``vmap``s the vote over (group, coordinate), this
port carries both as batch dimensions of one batched inverse.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.berrut import chebyshev_first_kind, \
    chebyshev_second_kind
from repro_torch.core.error_locator import chebyshev_design, \
    gather_vote_values
from repro_torch.core.replication import nanmedian
from repro_torch.core.scheme import RedundancyScheme, register_scheme

# keeps every decoder Gram matrix positive definite, so that any mask,
# speculative decodes below the quorum included, gives a finite solve
_GRAM_EPS = 1e-8
# vote-threshold floor relative to the signal RMS: on clean rounds where
# the regression is near exact the median residual is numerical noise
_VOTE_FLOOR = 1e-3


def _cheb_design_np(x: np.ndarray, degree: int) -> np.ndarray:
    """float64 numpy Chebyshev design matrix, for the static encoder."""
    cols = [np.ones_like(x)]
    if degree >= 1:
        cols.append(x)
    for _ in range(2, degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return np.stack(cols, axis=-1)


def _roughness_np(degree: int) -> np.ndarray:
    """Diagonal roughness penalty diag(m^4), m = Chebyshev order; order 0
    is never penalised, so both layers reproduce constants exactly."""
    m = np.arange(degree + 1, dtype=np.float64)
    return np.diag(m ** 4)


@dataclasses.dataclass(frozen=True)
class NeRCCConfig:
    """NeRCC redundancy and regression parameters (hashable).

    K/S/E and the worker geometry are ``CodingConfig``'s: N+1 = K+S
    workers with E = 0, 2(K+E)+S with E > 0, the K+2E locator quorum.
    ``degree_enc`` / ``degree_dec`` (-1: K-1, interpolating) and
    ``lambda_enc`` / ``lambda_dec`` are the nested-regression knobs.
    """

    k: int
    s: int = 1
    e: int = 0
    degree_enc: int = -1        # -1 -> K-1 (encoder interpolates)
    degree_dec: int = -1        # -1 -> K-1
    lambda_enc: float = 0.0
    lambda_dec: float = 1e-6
    c_vote: int = 64            # locator vote coordinates
    vote_tau: float = 6.0       # residual-outlier multiple for one vote

    def __post_init__(self):
        if self.k < 1 or self.s < 0 or self.e < 0:
            raise ValueError(f"invalid NeRCC config {self}")
        if self.degree_enc < -1 or self.degree_dec < -1:
            raise ValueError(f"regression degrees must be >= 0 (or -1 for "
                             f"K-1), got {self}")
        if self.lambda_enc < 0.0 or self.lambda_dec < 0.0:
            raise ValueError(f"ridge strengths must be >= 0, got {self}")

    @property
    def n(self) -> int:
        if self.e == 0:
            return self.k + self.s - 1
        return 2 * (self.k + self.e) + self.s - 1

    @property
    def num_workers(self) -> int:
        return self.n + 1

    @property
    def wait_for(self) -> int:
        if self.e == 0:
            return self.k
        return 2 * (self.k + self.e)

    @property
    def decode_quorum(self) -> int:
        if self.e == 0:
            return self.k
        return min(self.k + 2 * self.e, self.num_workers)

    @property
    def overhead(self) -> float:
        return self.num_workers / self.k

    @property
    def alphas(self) -> np.ndarray:
        return chebyshev_first_kind(self.k)

    @property
    def betas(self) -> np.ndarray:
        return chebyshev_second_kind(self.n)

    @property
    def d_enc(self) -> int:
        return self.k - 1 if self.degree_enc < 0 else self.degree_enc

    @property
    def d_dec(self) -> int:
        return self.k - 1 if self.degree_dec < 0 else self.degree_dec


@functools.lru_cache(maxsize=None)
def _encode_matrix_np(k: int, s: int, e: int, degree: int,
                      lam: float) -> np.ndarray:
    """Static (W, K) layer-1 matrix: the ridge Chebyshev regression fit
    at the anchors, evaluated at the worker nodes, in float64 numpy and
    cast to float32 as the reference does (so the two are equal)."""
    cfg = NeRCCConfig(k=k, s=s, e=e, degree_enc=degree, lambda_enc=lam)
    d = cfg.d_enc
    pa = _cheb_design_np(np.asarray(cfg.alphas, np.float64), d)
    pb = _cheb_design_np(np.asarray(cfg.betas, np.float64), d)
    gram = pa.T @ pa + lam * _roughness_np(d) + 1e-12 * np.eye(d + 1)
    return (pb @ np.linalg.solve(gram, pa.T)).astype(np.float32)


def encode_matrix(cfg: NeRCCConfig, device=None) -> torch.Tensor:
    return torch.from_numpy(_encode_matrix_np(
        cfg.k, cfg.s, cfg.e, cfg.d_enc, cfg.lambda_enc)).to(device)


def _designs(cfg: NeRCCConfig, device):
    """(phi at the worker nodes (W, D+1), phi at the anchors (K, D+1),
    the decoder's ridge + epsilon term (D+1, D+1)), fp32."""
    d = cfg.d_dec
    f32 = dict(dtype=torch.float32, device=device)
    phi_b = chebyshev_design(torch.as_tensor(cfg.betas, **f32), d)
    phi_a = chebyshev_design(torch.as_tensor(cfg.alphas, **f32), d)
    reg = (cfg.lambda_dec * torch.as_tensor(_roughness_np(d), **f32)
           + _GRAM_EPS * torch.eye(d + 1, **f32))
    return phi_b, phi_a, reg


def decode_matrix(cfg: NeRCCConfig, mask) -> torch.Tensor:
    """(K, W) layer-2 matrix for an availability mask (W,), or (..., K, W)
    for masks (..., W): the ridge Chebyshev regression through the
    surviving outputs, evaluated back at the anchors.  The ridge and
    epsilon terms keep the Gram matrix positive definite for any mask."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    phi_b, phi_a, reg = _designs(cfg, m.device)
    gram = phi_b.T @ (m[..., :, None] * phi_b) + reg
    rhs = phi_b.T * m[..., None, :]
    return phi_a @ torch.linalg.solve_ex(gram, rhs)[0]


def _group_votes(cfg: NeRCCConfig, vals: torch.Tensor,
                 avail2d: torch.Tensor) -> torch.Tensor:
    """(G, W, C) vote values + (G, W) availability -> (G, W) int votes.

    Per (group, coordinate): greedily remove the E workers of largest
    internally studentised residual, refit on the rest, and vote for a
    removed worker only when its externally studentised residual against
    that refit (its miss discounted by sqrt(1 + h~), h~ the refit's
    leverage at its node) is an outlier multiple of the refit's robust
    (MAD) residual scale.  Removing before refitting keeps one loud liar
    from inflating every residual of a K+2E fit; the discount keeps an
    honest worker at an extrapolating node from reading as an outlier.
    Ties in the removal take the lowest worker, as ``argmax`` does.
    """
    phi, _, reg = _designs(cfg, vals.device)
    y = vals.transpose(1, 2)                       # (G, C, W)
    m0 = avail2d.to(torch.float32)[:, None, :].expand_as(y)

    def fit_residuals(m):
        gram = phi.T @ (m[..., :, None] * phi) + reg        # (G, C, D, D)
        ginv = torch.linalg.inv_ex(gram)[0]
        coef = ginv @ (phi.T @ (m * y)[..., None])          # (G, C, D, 1)
        resid = (y - (phi @ coef)[..., 0]).abs()
        lev = ((phi @ ginv) * phi).sum(-1)      # phi_i^T G^-1 phi_i
        return resid, lev

    m, removed = m0, torch.zeros_like(m0)
    for _ in range(cfg.e):
        resid, lev = fit_residuals(m)
        stud = resid * m / torch.sqrt((1.0 - lev * m).clamp_min(5e-2))
        sel = torch.nn.functional.one_hot(stud.argmax(-1),
                                          m.shape[-1]).to(m.dtype)
        removed = removed + sel * m
        m = m * (1.0 - sel)
    resid, lev = fit_residuals(m)                  # the honest refit
    # robust sigma from the refit's inliers (in-sample leverage < 1)
    inlier = resid / torch.sqrt((1.0 - lev * m).clamp_min(5e-2))
    sigma = 1.4826 * nanmedian(torch.where(m > 0, inlier, torch.nan), -1)
    # held-out misses, discounted by their prediction variance
    t_out = resid / torch.sqrt(1.0 + lev.clamp_min(0.0))
    rms = torch.sqrt(((y * m0) ** 2).sum(-1)
                     / m0.sum(-1).clamp_min(1.0))
    thr = cfg.vote_tau * sigma + _VOTE_FLOOR * rms + 1e-6
    votes = (removed > 0) & (t_out > thr[..., None])
    return votes.sum(1).to(torch.int32)            # (G, W)


@register_scheme("nercc", description="NeRCC nested-regression code "
                 "(arXiv 2402.04377): ridge Chebyshev regression "
                 "encode/decode, Berrut-geometry locator quorum")
def _make_nercc(k: int, s: int = 1, e: int = 0, *, degree_enc: int = -1,
                degree_dec: int = -1, lambda_enc: float = 0.0,
                lambda_dec: float = 1e-6, c_vote: int = 64,
                vote_tau: float = 6.0) -> "NeRCCScheme":
    return NeRCCScheme(NeRCCConfig(k=k, s=s, e=e, degree_enc=degree_enc,
                                   degree_dec=degree_dec,
                                   lambda_enc=lambda_enc,
                                   lambda_dec=lambda_dec, c_vote=c_vote,
                                   vote_tau=vote_tau))


class NeRCCScheme(RedundancyScheme):
    """NeRCC behind the ``RedundancyScheme`` protocol.  With the
    interpolating defaults the full-availability round trip is exact for
    linear models up to the decoder's O(lambda_dec) ridge bias."""

    name = "nercc"

    @property
    def has_locator(self) -> bool:
        return self.config.e > 0

    def with_redundancy(self, *, s: Optional[int] = None,
                        e: Optional[int] = None) -> "NeRCCScheme":
        s = self.s if s is None else s
        e = self.e if e is None else e
        if (s, e) == (self.s, self.e):
            return self
        # keep the regression knobs the registry default would drop
        return NeRCCScheme(dataclasses.replace(self.config, s=s, e=e))

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        w = encode_matrix(self.config, grouped.device).to(grouped.dtype)
        coded = torch.tensordot(w, grouped.movedim(1, 0), dims=([1], [0]))
        return coded.movedim(0, 1)

    def _apply_decode(self, outputs: torch.Tensor, avail) -> torch.Tensor:
        g, w = outputs.shape[:2]
        y = outputs.to(torch.float32).reshape(g, w, -1)
        avail = torch.as_tensor(avail, dtype=torch.float32,
                                device=outputs.device)
        if avail.dim() == 1:
            out = torch.einsum("kw,gwc->gkc",
                               decode_matrix(self.config, avail), y)
        else:
            out = torch.einsum("gkw,gwc->gkc",
                               decode_matrix(self.config, avail), y)
        out = out.reshape(g * self.k, *outputs.shape[2:])
        return out.to(outputs.dtype)

    def decode(self, outputs: torch.Tensor, avail, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        if locate is None:
            locate = self.config.e > 0
        if locate and self.config.e > 0:
            return self.locate(outputs, avail)[0]
        return self._apply_decode(outputs, avail)

    def locate(self, outputs: torch.Tensor, avail
               ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
        """Residual-vote locator, vote-gated and pooled over the groups:
        worker i owns stream i of every group, so a worker is located
        only when it wins a majority of all G * C_vote coordinates and
        sits in the pooled top E (a stable walk down the tally)."""
        cfg = self.config
        if cfg.e == 0:
            return super().locate(outputs, avail)
        g, w = outputs.shape[:2]
        vals = gather_vote_values(outputs.reshape(g, w, -1), cfg.c_vote)
        avail2d = torch.as_tensor(avail, dtype=torch.float32,
                                  device=outputs.device).expand(g, w)
        votes = _group_votes(cfg, vals, avail2d).cpu().numpy()
        pooled = votes.sum(axis=0)                       # (W,)
        total = g * vals.shape[-1]
        located1 = np.zeros(w, bool)
        for i in np.argsort(-pooled, kind="stable")[:cfg.e]:
            if pooled[i] > total / 2.0:
                located1[i] = True
        located = np.broadcast_to(located1, (g, w)).copy()
        masks = avail2d.cpu().numpy() * ~located
        decoded = self._apply_decode(outputs, masks)
        votes2d = np.broadcast_to(pooled.astype(np.int32), (g, w)).copy()
        return decoded, located, votes2d, masks
