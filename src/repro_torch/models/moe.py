"""Mixture-of-Experts layer: top-k router and capacity-based einsum
dispatch (port of ``repro.models.moe``).

Covers qwen3-moe-30b-a3b (128 experts, top-8, renormalised top-k
probabilities) and grok-1-314b (8 experts, top-2, softmax over all
experts).  As in the reference, tokens split into groups of
``moe_group_size`` (halved until it divides the token count); each
expert takes at most ``_capacity`` tokens of a group, in token order,
and a token past that is dropped by that expert.  The dispatch and the
expert products are dense einsums over every expert.  On a mesh the
groups and capacity stay the whole batch's when the batch is split over
the "worker", "pod" and "data" axes, and the "model" axis splits the
experts or their hidden units where ``resolve_spec`` puts "experts" or
"expert_ffn" (``moe_block``).

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

from repro_torch.models import layers, partitioning
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




def _batch_groups() -> list:
    """The active mesh's groups that split the batch's rows, inner first:
    the batch group ("pod" and "data" jointly, in block order), then
    "worker".  Concatenated in that order, the ranks' blocks are the whole
    batch in ``partitioning.batch_block``'s order, worker outermost."""
    mesh = partitioning.active_mesh()
    if mesh is None:
        return []
    return [g for g in (mesh.group("fsdp"), mesh.group("worker"))
            if g is not None]


def whole_routes(top_i: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """This rank's (tokens, k) expert indices all-gathered over the
    batch groups (``_batch_groups``): the whole batch's, in its flat token
    order (stream-major, then sequence), and the index of this rank's
    first token in it.  Off any split batch, ``top_i`` and 0."""
    start, span = 0, top_i.shape[0]
    for group in _batch_groups():
        start += group.rank * span
        span *= group.size
        top_i = group.all_gather(top_i, 0)
    return top_i, start


def _widen(t: torch.Tensor, lead: int, tail: int) -> torch.Tensor:
    """``t``'s rows (dim 0) placed at ``lead`` among zero rows."""
    if not (lead or tail):
        return t
    return F.pad(t, (0, 0) * (t.dim() - 1) + (lead, tail))


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (B, S, d), plus aux metrics (load-balance loss,
    router z-loss, dropped fraction).

    On a batch split over the active mesh's "worker", "pod" and "data"
    axes ``x`` is this rank's block of the whole batch's rows, and the
    layer computes what the reference computes on the whole batch: the
    ranks all-gather their top-k expert indices (``whole_routes``), so
    that the group size, the capacity and each token's place in its
    expert's buffer are the whole batch's; a rank then dispatches only
    its own kept tokens, into the buffers of the groups that hold them.
    The aux losses come back as this rank's shares, which sum over the
    batch groups to the whole batch's (the load-balance loss's
    ``frac_tokens`` is the whole batch's, from the gathered routes, and
    carries no gradient); ``dropped_fraction`` is the whole batch's.

    On a model axis a rank holds a block of the experts, or of every
    expert's hidden units (read from the leaves' shapes): the router
    stays whole, the dispatch is computed for every expert, the rank
    contracts its slice, and the output is a partial sum, all-reduced
    over the axis.  The tokens into the expert products and the
    per-expert combine weights enter through ``ModelGroup.enter``: their
    consumers are the rank's slice alone.  The router's own input and
    weight do not: the aux losses that also read them are whole on every
    rank."""
    bsz, s, d = x.shape
    local = bsz * s
    e, k = cfg.num_experts, cfg.experts_per_token

    xt = x.reshape(local, d)
    top_p, top_i, full = router_probs(cfg, p, xt)           # (T, k)
    routes, start = whole_routes(top_i)
    tokens = routes.shape[0]
    gs = group_size(cfg, tokens)
    cap = _capacity(cfg, gs)

    experts = torch.arange(e, device=x.device)
    emask = (routes[..., None] == experts).to(torch.float32).sum(1)
    grouped = emask.reshape(tokens // gs, gs, e)
    # position of each token within its expert's capacity buffer
    pos_in_e = (torch.cumsum(grouped, dim=1) - grouped).reshape(tokens, e)
    keep = (pos_in_e < cap) * emask                         # (tokens, e)

    # the whole groups that hold this rank's tokens, its rows among them
    first, last = start // gs, -(-(start + local) // gs)
    lead = start - first * gs
    tail = (last - first) * gs - lead - local
    keep_w = _widen(keep[start:start + local], lead, tail)
    # a 0/1 tensor: built in x's dtype, where the reference casts it
    slots = torch.arange(cap, device=x.device)
    dispatch = ((pos_in_e[first * gs:last * gs].to(torch.int64)[..., None]
                 == slots) & (keep_w > 0)[..., None]).to(x.dtype)
    dispatch = dispatch.reshape(last - first, gs, e, cap)
    onehot = (top_i[..., None] == experts).to(torch.float32)  # (T, k, e)
    probs_per_e = (onehot * top_p[..., None]).sum(1)        # (T, e)

    el, f_local = p["w_gate"].shape[0], p["w_gate"].shape[2]
    group = (partitioning.model_group()
             if el < e or f_local < cfg.moe_d_ff else None)
    xe = xt
    if group is not None:
        xe, probs_per_e = group.enter(xt), group.enter(probs_per_e)
    xe = _widen(xe, lead, tail).reshape(last - first, gs, d)
    # dispatch * probs, cast to x's dtype: 0/1 times the rounded prob
    # is the rounded product
    combine = dispatch * _widen(probs_per_e, lead, tail).to(x.dtype) \
        .reshape(last - first, gs, e)[..., None]
    if el < e:                           # this rank's block of the experts
        e0 = group.rank * el
        dispatch = dispatch[:, :, e0:e0 + el]
        combine = combine[:, :, e0:e0 + el]

    xin = torch.einsum("gsec,gsd->egcd", dispatch, xe)
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, p["w_gate"])) \
        * torch.einsum("egcd,edf->egcf", xin, p["w_in"])
    y_e = torch.einsum("egcf,efd->egcd", h, p["w_out"])
    y = torch.einsum("gsec,egcd->gsd", combine, y_e)
    y = y.reshape(-1, d)[lead:lead + local]
    if group is not None:
        y = group.all_reduce(y)

    # Switch-style load-balance aux loss + routing stats: this rank's
    # shares of the whole batch's
    frac_tokens = emask.mean(dim=0) / k                     # (e,)
    aux = {
        "load_balance_loss": e * (frac_tokens * full.sum(dim=0)
                                  / tokens).sum(),
        "router_z_loss": torch.logsumexp(
            router_logits(p, xt), dim=-1).square().sum() / tokens,
        "dropped_fraction": 1.0 - keep.sum() / (tokens * k),
    }
    return y.reshape(bsz, s, d), aux
