"""Public model API: init / prefill / decode (port of ``repro.models.model``,
text inputs, dense attention and Mamba2 blocks).

Inputs are dicts as in the reference: ``{"tokens": (B, S) int}`` or
``{"embeddings": (B, S, d)}``; "embeddings" bypasses the token table and
is how the coded serving steps feed coded queries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the reference's structure, shapes and
    scales, drawn from ``generator`` (which must live on ``device``'s
    type).  ``device=None`` means CUDA."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"parameters on {device}")
    dtype = param_dtype(cfg)
    return {
        "embeddings": layers.init_embeddings(cfg, generator, dtype, device),
        "blocks": transformer.init_blocks(cfg, generator, dtype, device),
        "final_norm": layers.init_norm(cfg, dtype, device),
    }


def embed_inputs(cfg: ModelConfig, params: dict,
                 inputs: dict) -> torch.Tensor:
    """-> (B, S, d) residual-stream inputs."""
    if "embeddings" in inputs:
        return inputs["embeddings"].to(param_dtype(cfg))
    return layers.embed_tokens(cfg, params["embeddings"], inputs["tokens"])


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device) -> list:
    return transformer.init_run_caches(cfg, batch, max_len, dtype, device)


def prefill(cfg: ModelConfig, params: dict, inputs: dict, caches: list
            ) -> Tuple[torch.Tensor, list]:
    """Process the full prompt; returns (last-token logits (B, V) fp32,
    caches), the caches written in place."""
    x = embed_inputs(cfg, params, inputs)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, caches = transformer.prefill_runs(cfg, params["blocks"], x,
                                         positions, caches)
    x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = layers.unembed(cfg, params["embeddings"], x)[:, 0]
    return logits.to(torch.float32), caches


def decode_step(cfg: ModelConfig, params: dict, caches: list, inputs: dict,
                pos, live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, list]:
    """One decode step.  inputs: {"tokens": (B, 1)} or {"embeddings":
    (B, 1, d)}; pos: the Python int position shared by every stream, or a
    (B,) int tensor of per-stream positions on the device (slot-pool
    continuous batching, DESIGN.md §10); live: optional (B,) slot-live
    mask handed to the pool attention kernel (a dead stream's attention
    is exact zeros; its row is masked downstream).  Returns (logits
    (B, V) fp32, caches), the caches written in place."""
    if "embeddings" in inputs:
        x = inputs["embeddings"].to(param_dtype(cfg))
    else:
        x = layers.embed_tokens(cfg, params["embeddings"], inputs["tokens"])
    x, caches = transformer.decode_runs(cfg, params["blocks"], x, pos, caches,
                                        live=live)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.unembed(cfg, params["embeddings"], x)[:, 0]
    return logits.to(torch.float32), caches
