"""Mixture-of-Experts layer: top-k router and capacity-based einsum
dispatch (port of ``repro.models.moe``).

Covers qwen3-moe-30b-a3b (128 experts, top-8, renormalised top-k
probabilities) and grok-1-314b (8 experts, top-2, softmax over all
experts).  As in the reference, tokens split into groups of
``moe_group_size`` (halved until it divides the token count); each
expert takes at most ``_capacity`` tokens of a group, in token order,
and a token past that is dropped by that expert.  The dispatch and the
expert products are dense einsums over every expert.

Two details of the reference are kept exactly: the top k come in
``jax.lax.top_k``'s order (``serving.sampling.top_k_stable``), and a
token whose place in its expert's buffer is at or past the capacity
gets an all-zero dispatch row, as ``jax.nn.one_hot`` gives for an index
out of range (``torch.nn.functional.one_hot`` would raise).  The router
and its softmax run in fp32 (the router weight is fp32 in a bf16 model
too); dispatch and combine enter the einsums in ``x``'s dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import top_k_stable


def moe_axes(cfg: ModelConfig) -> dict:
    return {
        "router": ("fsdp", None),
        "w_gate": ("experts", "fsdp", "expert_ffn"),
        "w_in": ("experts", "fsdp", "expert_ffn"),
        "w_out": ("experts", "expert_ffn", "fsdp"),
    }


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5
    return {
        "router": layers.dense_init(gen, d, e, torch.float32, device),
        "w_gate": layers.trunc_normal(gen, (e, d, f), d ** -0.5, dtype,
                                      device),
        "w_in": layers.trunc_normal(gen, (e, d, f), d ** -0.5, dtype,
                                    device),
        "w_out": layers.trunc_normal(gen, (e, f, d), f ** -0.5 * out_scale,
                                     dtype, device),
    }


def _capacity(cfg: ModelConfig, group_size: int) -> int:
    cap = group_size * cfg.experts_per_token / cfg.num_experts
    cap = int(math.ceil(cap * cfg.capacity_factor / 4.0)) * 4
    return max(cap, 4)


def group_size(cfg: ModelConfig, tokens: int) -> int:
    """Tokens per dispatch group: ``moe_group_size``, or fewer tokens,
    halved until it divides ``tokens`` (the reference's loop)."""
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs:
        gs //= 2
    return gs


def router_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., E) fp32 router logits."""
    return x.to(torch.float32) @ p["router"]


def router_probs(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Top-k routing.  Returns (probs (..., k), idx (..., k), full_probs)."""
    full = torch.softmax(router_logits(p, x), dim=-1)
    top_p, top_i = top_k_stable(full, cfg.experts_per_token)
    if cfg.router_norm_topk:
        top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    return top_p, top_i, full


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (B, S, d), plus aux metrics (load-balance loss,
    router z-loss, dropped fraction)."""
    bsz, s, d = x.shape
    tokens = bsz * s
    gs = group_size(cfg, tokens)
    g = tokens // gs
    cap = _capacity(cfg, gs)
    e, k = cfg.num_experts, cfg.experts_per_token

    xt = x.reshape(g, gs, d)
    top_p, top_i, full = router_probs(cfg, p, xt)           # (g, gs, k)

    experts = torch.arange(e, device=x.device)
    onehot = (top_i[..., None] == experts).to(torch.float32)  # (g, gs, k, e)
    emask = onehot.sum(2)                                   # (g, gs, e)
    # position of each token within its expert's capacity buffer
    pos_in_e = torch.cumsum(emask, dim=1) - emask           # (g, gs, e)
    keep = (pos_in_e < cap) * emask
    # a 0/1 tensor: built in x's dtype, where the reference casts it
    slots = torch.arange(cap, device=x.device)
    dispatch = ((pos_in_e.to(torch.int64)[..., None] == slots)
                & (keep > 0)[..., None]).to(x.dtype)        # (g, gs, e, c)
    probs_per_e = (onehot * top_p[..., None]).sum(2)       # (g, gs, e)
    # dispatch * probs, cast to x's dtype: 0/1 times the rounded prob
    # is the rounded product
    combine = dispatch * probs_per_e.to(x.dtype)[..., None]

    xin = torch.einsum("gsec,gsd->egcd", dispatch, xt)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, p["w_gate"])) \
        * torch.einsum("egcd,edf->egcf", xin, p["w_in"])
    y_e = torch.einsum("egcf,efd->egcd", h, p["w_out"])
    y = torch.einsum("gsec,egcd->gsd", combine, y_e)

    # Switch-style load-balance aux loss + routing stats
    frac_tokens = emask.mean(dim=(0, 1)) / k                # (e,)
    mean_prob = full.mean(dim=(0, 1))                       # (e,)
    aux = {
        "load_balance_loss": e * (frac_tokens * mean_prob).sum(),
        "router_z_loss": torch.logsumexp(
            router_logits(p, xt), dim=-1).square().mean(),
        "dropped_fraction": 1.0 - keep.sum() / (tokens * k),
    }
    return y.reshape(bsz, s, d), aux
