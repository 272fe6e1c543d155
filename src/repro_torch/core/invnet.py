"""Coded-InvNet: invertible-network mixup parity (arXiv 2106.06445); port
of ``repro.core.invnet``.

Map the K queries of a group into a latent space with an exactly
invertible network T, form parity latents as convex mixtures of the
latent codes, and map them back through T^-1, so that every parity
stream is an input the hosted model runs unchanged:

    p_m = T^-1( sum_i c_{m,i} T(x_i) ),      sum_i c_{m,i} = 1

A failed data stream is reconstructed from the parity outputs and the
survivors by a small per-group least-squares solve over the missing
slots.  ``CouplingFlow`` is an additive (NICE) coupling network, closed
form both ways; the mixture rows are a row-normalised totally positive
Vandermonde matrix, so any r <= S missing data streams are recoverable
from any r parity streams.  ``flow=None`` is the trained-free fallback
(identity latent map); ``parity_fn`` runs a fine-tuned model over the
parity streams, as ParM's does.  No Byzantine mode: ``e > 0`` is
rejected.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.scheme import RedundancyScheme, register_scheme


class CouplingFlow:
    """Additive coupling flow over the trailing feature axis: ``depth``
    alternating NICE couplings (even layers shift the second half of the
    features by an MLP of the first half, odd layers the reverse), so
    ``inverse(forward(x)) == x`` to fp32 round-off.  The weights are drawn
    from ``np.random.RandomState(seed)`` as the reference draws them, so
    both packages hold the identical flow."""

    def __init__(self, dim: int, depth: int = 2, hidden: int = 32,
                 seed: int = 0):
        if dim < 2:
            raise ValueError(f"coupling flows need dim >= 2, got {dim}")
        if depth < 1:
            raise ValueError(f"need depth >= 1, got {depth}")
        self.dim, self.depth = dim, depth
        d1 = dim // 2
        rng = np.random.RandomState(seed)
        self.layers = []
        for layer in range(depth):
            a, b = (d1, dim - d1) if layer % 2 == 0 else (dim - d1, d1)
            w1 = rng.randn(a, hidden).astype(np.float32) / np.sqrt(a)
            b1 = np.zeros(hidden, np.float32)
            w2 = rng.randn(hidden, b).astype(np.float32) / np.sqrt(hidden)
            # numpy divides in float64 here; the reference's arrays hold
            # the float32 rounding of the quotient, and so do these
            self.layers.append(tuple(torch.from_numpy(np.float32(t))
                                     for t in (w1, b1, w2)))
        self._copies = {}

    def _layer(self, i: int, like: torch.Tensor):
        """Layer ``i``'s weights on ``like``'s device and dtype, copied
        there once."""
        key = (like.device, like.dtype)
        if key not in self._copies:
            self._copies[key] = [tuple(t.to(like.device, like.dtype)
                                       for t in layer)
                                 for layer in self.layers]
        return self._copies[key][i]

    @staticmethod
    def _shift(x: torch.Tensor, layer) -> torch.Tensor:
        w1, b1, w2 = layer
        return torch.tanh(x @ w1 + b1) @ w2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = self.dim // 2
        for i in range(self.depth):
            xa, xb = x[..., :d1], x[..., d1:]
            if i % 2 == 0:
                xb = xb + self._shift(xa, self._layer(i, x))
            else:
                xa = xa + self._shift(xb, self._layer(i, x))
            x = torch.cat([xa, xb], dim=-1)
        return x

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        d1 = self.dim // 2
        for i in reversed(range(self.depth)):
            ya, yb = y[..., :d1], y[..., d1:]
            if i % 2 == 0:
                yb = yb - self._shift(ya, self._layer(i, y))
            else:
                ya = ya - self._shift(yb, self._layer(i, y))
            y = torch.cat([ya, yb], dim=-1)
        return y


@dataclasses.dataclass(frozen=True)
class InvNetConfig:
    """Coded-InvNet parameters: K data + S parity streams per group.
    ``depth`` / ``hidden`` / ``flow_seed`` describe the auto-built flow;
    ``ridge`` regularises the recovery least squares (1e-8 keeps single-
    failure reconstruction exact to fp32 round-off, and the solve total
    for any mask)."""

    k: int
    s: int = 1
    e: int = 0
    depth: int = 2
    hidden: int = 32
    flow_seed: int = 0
    ridge: float = 1e-8

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"need K >= 1, got {self.k}")
        if self.s < 1:
            raise ValueError(f"Coded-InvNet needs at least one parity "
                             f"stream, got s={self.s}")
        if self.e != 0:
            raise ValueError("Coded-InvNet has no Byzantine recovery "
                             f"(e must be 0, got {self.e})")

    @property
    def num_workers(self) -> int:
        return self.k + self.s

    @property
    def wait_for(self) -> int:
        return self.k

    @property
    def decode_quorum(self) -> int:
        return self.k


@functools.lru_cache(maxsize=None)
def _mixup_coeffs_np(k: int, s: int) -> np.ndarray:
    """(S, K) row-normalised mixture coefficients: generalised Vandermonde
    rows t_i^m, t_i = 1 + (i+1)/K in (1, 2], m = 0..S-1 (totally positive,
    so every square submatrix is nonsingular); row m = 0 is the uniform
    mixture."""
    t = 1.0 + (np.arange(k) + 1.0) / k
    v = t[None, :] ** np.arange(s, dtype=np.float64)[:, None]
    return (v / v.sum(axis=1, keepdims=True)).astype(np.float32)


@register_scheme("invnet", description="Coded-InvNet invertible-flow "
                 "mixup parity (arXiv 2106.06445): exact single-failure "
                 "reconstruction, trained-free fallback")
def _make_invnet(k: int, s: int = 1, e: int = 0, *,
                 flow: Union[str, CouplingFlow, None] = "auto",
                 depth: int = 2, hidden: int = 32, flow_seed: int = 0,
                 ridge: float = 1e-8,
                 parity_fn: Optional[Callable] = None) -> "InvNetScheme":
    return InvNetScheme(InvNetConfig(k=k, s=s, e=e, depth=depth,
                                     hidden=hidden, flow_seed=flow_seed,
                                     ridge=ridge),
                        flow=flow, parity_fn=parity_fn)


class InvNetScheme(RedundancyScheme):
    """Coded-InvNet behind the ``RedundancyScheme`` protocol.  ``flow``
    is ``"auto"`` (a ``CouplingFlow`` built lazily per feature dimension,
    deterministic in ``flow_seed``), a flow, or ``None`` (identity latent
    map).  Decode works on worker outputs and never needs the flow."""

    name = "invnet"

    def __init__(self, config: InvNetConfig,
                 flow: Union[str, CouplingFlow, None] = "auto",
                 parity_fn: Optional[Callable] = None):
        super().__init__(config)
        self.flow = flow
        self.parity_fn = parity_fn
        self._auto_flows = {}

    def _flow_for(self, dim: int) -> Optional[CouplingFlow]:
        if self.flow is None:
            return None
        if isinstance(self.flow, str):          # "auto": lazily per dim
            if dim < 2:
                return None                      # scalar features: identity
            fl = self._auto_flows.get(dim)
            if fl is None:
                cfg = self.config
                fl = CouplingFlow(dim, depth=cfg.depth, hidden=cfg.hidden,
                                  seed=cfg.flow_seed)
                self._auto_flows[dim] = fl
            return fl
        return self.flow

    def with_redundancy(self, *, s: Optional[int] = None,
                        e: Optional[int] = None) -> "InvNetScheme":
        s = self.s if s is None else s
        e = self.e if e is None else e
        if (s, e) == (self.s, self.e):
            return self
        # e != 0 fails in InvNetConfig: a controller over this scheme
        # must bound its range at e_max = 0
        return InvNetScheme(dataclasses.replace(self.config, s=s, e=e),
                            flow=self.flow, parity_fn=self.parity_fn)

    def encode(self, grouped: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        coeffs = torch.from_numpy(_mixup_coeffs_np(cfg.k, cfg.s)).to(
            grouped.device, grouped.dtype)
        flow = self._flow_for(grouped.shape[-1])
        z = flow.forward(grouped) if flow is not None else grouped
        parity_z = torch.tensordot(coeffs, z, dims=([1], [1])).movedim(0, 1)
        parity = flow.inverse(parity_z) if flow is not None else parity_z
        return torch.cat([grouped, parity], dim=1)

    def forward(self, predict_fn, coded: torch.Tensor) -> torch.Tensor:
        if self.parity_fn is None:
            # trained-free: data and parity streams run the hosted model
            return super().forward(predict_fn, coded)
        k, s, g = self.k, self.s, coded.shape[0]
        data_preds = predict_fn(coded[:, :k].reshape(g * k,
                                                     *coded.shape[2:]))
        parity_preds = self.parity_fn(coded[:, k:].reshape(
            g * s, *coded.shape[2:]))
        data_preds = data_preds.reshape(g, k, *data_preds.shape[1:])
        parity_preds = parity_preds.reshape(g, s, *parity_preds.shape[1:])
        return torch.cat([data_preds, parity_preds], dim=1)

    def decode(self, outputs: torch.Tensor, avail, *,
               locate: Optional[bool] = None) -> torch.Tensor:
        """Pass the available data outputs through; reconstruct the
        missing ones from the parity equations q_m ~ sum_i c_{m,i} y_i by
        a per-group (S x S) ridge least-squares solve over the missing
        slots, with fixed shapes for any mask."""
        del locate
        cfg = self.config
        k, s = cfg.k, cfg.s
        g, w = outputs.shape[:2]
        y = outputs.to(torch.float32).reshape(g, w, -1)
        avail2d = torch.as_tensor(avail, dtype=torch.float32,
                                  device=outputs.device).expand(g, w)
        ad, ap = avail2d[:, :k], avail2d[:, k:]
        coeffs = torch.from_numpy(_mixup_coeffs_np(k, s)).to(outputs.device)
        data, parity = y[:, :k], y[:, k:]
        # what each available parity equation still owes: its output less
        # the part of the data streams that did land
        known = torch.einsum("mi,gi,gic->gmc", coeffs, ad, data)
        resid = ap[..., None] * (parity - known)
        basis = ap[:, :, None] * coeffs[None] * (1.0 - ad[:, None, :])
        gram = (torch.einsum("gmi,gni->gmn", basis, basis)
                + cfg.ridge * torch.eye(s, dtype=torch.float32,
                                        device=outputs.device))
        recon = torch.einsum("gmi,gmc->gic", basis,
                             torch.linalg.solve_ex(gram, resid)[0])
        out = data * ad[..., None] + (1.0 - ad[..., None]) * recon
        return out.reshape(g * k, *outputs.shape[2:]).to(outputs.dtype)
