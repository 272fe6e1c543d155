"""Shared layers: norms, rotary embeddings, initialisers, embedding tables
(port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors with the reference's
structure and shapes, so converted JAX parameters and the port's own
initialisation are interchangeable.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import partitioning
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------- init utils

def trunc_normal(gen: torch.Generator, shape, std: float, dtype,
                 device) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], drawn in fp32 from ``gen``; on
    the meta device the shape and dtype alone, nothing drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    return trunc_normal(gen, (d_in, d_out), scale / math.sqrt(d_in), dtype,
                        device)


# ---------------------------------------------------------------- norms

def norm_axes(cfg: ModelConfig) -> dict:
    ax = {"scale": ("d_model",)}
    if cfg.norm_type == "layernorm":
        ax["bias"] = ("d_model",)
    return ax


def init_norm(cfg: ModelConfig, dtype, device) -> dict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm, or LayerNorm with a bias (``norm_type="layernorm"``), in
    fp32.  LayerNorm divides by the population variance, as ``jnp.var``
    does (``correction=0``; torch's default would be the sample one)."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].to(torch.float32) \
            + p["bias"].to(torch.float32)
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) \
            * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-head RMSNorm over the head_dim axis (qwen3 qk_norm)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------- rotary

def rope_frequencies(cfg: ModelConfig, device) -> torch.Tensor:
    """Inverse frequencies for the rotated fraction of head_dim."""
    rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    exponent = (torch.arange(0, rot, 2, dtype=torch.float32, device=device)
                / max(rot, 1))
    return 1.0 / (cfg.rope_theta ** exponent)          # (rot/2,)


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, head_dim); positions: (B, S) or (S,)."""
    rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    if rot == 0:
        return x
    inv = rope_frequencies(cfg, x.device)               # (rot/2,)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., None] * inv[None, None, :]        # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------- embeddings

def embeddings_axes(cfg: ModelConfig) -> dict:
    ax = {"embed": ("vocab", "fsdp")}
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("fsdp", "vocab")
    if cfg.modality in ("audio", "vlm") and cfg.frontend_dim:
        ax["frontend_proj"] = ("fsdp", "d_model")
    return ax


def init_embeddings(cfg: ModelConfig, gen: torch.Generator, dtype,
                    device) -> dict:
    # unit-RMS after the sqrt(d) input scaling; keeps tied-unembed logits
    # O(1) at init
    p = {"embed": trunc_normal(gen, (cfg.vocab_size, cfg.d_model),
                               cfg.d_model ** -0.5, dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                  device)
    if cfg.modality in ("audio", "vlm") and cfg.frontend_dim:
        p["frontend_proj"] = dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                        dtype, device)
    return p


def embed_tokens(cfg: ModelConfig, p: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings.  A model-axis rank holding its block of the
    vocabulary's rows looks up the tokens in its block, gives zeros for
    the others and all-reduces over the axis: each sum is one row and
    zeros, so the result is the whole table's bit for bit."""
    table = p["embed"]
    if table.shape[0] == cfg.vocab_size:
        e = table[tokens]
        return (e * math.sqrt(cfg.d_model)).to(e.dtype)
    group = partitioning.model_group()
    local = tokens - group.rank * table.shape[0]
    inside = (local >= 0) & (local < table.shape[0])
    e = table[local.clamp(0, table.shape[0] - 1)]
    e = (e * math.sqrt(cfg.d_model)).to(e.dtype)
    return group.all_reduce(torch.where(inside[..., None], e,
                                        torch.zeros_like(e)))


def project_frontend(cfg: ModelConfig, p: dict,
                     frames: torch.Tensor) -> torch.Tensor:
    """Project stubbed frame / patch embeddings (B, T, frontend_dim) into
    the residual stream."""
    return frames.to(p["frontend_proj"].dtype) @ p["frontend_proj"]


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary; a model-axis rank's block of it is
    all-gathered over the axis (the coded tail reads whole rows, with
    unit stride), ``x`` entering the block's product through
    ``ModelGroup.enter`` (its gradient summed over the axis)."""
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    if w.shape[-1] == cfg.vocab_size:
        return x @ w
    group = partitioning.model_group()
    return group.all_gather(group.enter(x) @ w, -1).contiguous()
