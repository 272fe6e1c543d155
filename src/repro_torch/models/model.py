"""Public model API: init / forward / loss / prefill / decode (port of
``repro.models.model``: dense attention, MoE, Mamba2 and zamba2's shared
blocks, with text, audio and vlm inputs).

Inputs are dicts as in the reference, so every modality has the same
entry points:
  text:  ``{"tokens": (B, S) int}``
  audio: ``{"frames": (B, T, frontend_dim)}`` (stubbed codec output)
  vlm:   ``{"patches": (B, P, frontend_dim), "tokens": (B, S_text)}``
or ``{"embeddings": (B, S, d)}``, optionally with ``"targets"`` and
``"loss_mask"`` for the loss; "embeddings" bypasses the token table and
is how the coded serving steps and ``predict_fn`` feed coded queries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers, partitioning, transformer
from repro_torch.models.config import ModelConfig


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def logical_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in ``init_params``' tree."""
    return {
        "embeddings": layers.embeddings_axes(cfg),
        "blocks": transformer.blocks_axes(cfg),
        "final_norm": layers.norm_axes(cfg),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the reference's structure, shapes and
    scales, drawn from ``generator`` (which must live on ``device``'s
    type).  ``device=None`` means CUDA."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"parameters on {device}")
    return _build_params(cfg, generator, device)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameters' shapes and dtypes (``init_params``' tree) as
    tensors on the meta device: nothing allocated, nothing drawn.  The
    dry run's stand-ins, as the reference's ``jax.eval_shape`` of its
    ``init_params``."""
    return _build_params(cfg, None, torch.device("meta"))


def _build_params(cfg: ModelConfig, generator, device) -> dict:
    dtype = param_dtype(cfg)
    return {
        "embeddings": layers.init_embeddings(cfg, generator, dtype, device),
        "blocks": transformer.init_blocks(cfg, generator, dtype, device),
        "final_norm": layers.init_norm(cfg, dtype, device),
    }


def embed_inputs(cfg: ModelConfig, params: dict,
                 inputs: dict) -> torch.Tensor:
    """-> (B, S, d) residual-stream inputs: audio frames projected; vlm
    patches projected, then the text's token embeddings after them on
    the sequence axis."""
    if "embeddings" in inputs:
        return inputs["embeddings"].to(param_dtype(cfg))
    emb = params["embeddings"]
    if cfg.modality == "audio":
        return layers.project_frontend(cfg, emb, inputs["frames"])
    if cfg.modality == "vlm":
        x = layers.project_frontend(cfg, emb, inputs["patches"])
        if "tokens" not in inputs:
            return x
        return torch.cat([x, layers.embed_tokens(cfg, emb, inputs["tokens"])],
                         dim=1)
    return layers.embed_tokens(cfg, emb, inputs["tokens"])


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def forward(cfg: ModelConfig, params: dict, inputs: dict
            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward.  Returns (logits (B, S, V) in the model's
    dtype, aux: the MoE statistics summed over the layers)."""
    x = embed_inputs(cfg, params, inputs)
    x, aux = transformer.apply_runs(cfg, params["blocks"], x, _positions(x))
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embeddings"], x), aux


def predict_fn(cfg: ModelConfig, params: dict):
    """(B, S, d) coded embeddings -> (B, V) last-position fp32 logits:
    the black-box ``f`` handed to the ApproxIFER engine."""
    def f(embeddings: torch.Tensor) -> torch.Tensor:
        logits, _ = forward(cfg, params, {"embeddings": embeddings})
        return logits[:, -1].to(torch.float32)

    return f


def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (causal; vlm: over the text suffix only,
    the patches being inputs), or per-position CE against
    ``batch["targets"]`` (encoder-only: hubert's frame labels).  With
    ``targets`` in a causal batch, targets[t] is the token after the
    position whose logits are used: logits at -(T+1) .. -2.
    ``loss_mask`` weighs the positions.  Returns (total, metrics) as the
    reference does.

    With the batch split over the active mesh's batch axes
    (``partitioning.fsdp_group``) the losses are this rank's shares,
    which sum over the group to the reference's over the whole batch:
    the local mean over the group's size (equal shards), or with a
    ``loss_mask`` the local masked sum over the mask summed over the
    group.  The MoE layer's load-balance and z-losses are its shares
    already (``moe.moe_block``), and its dropped fraction, the whole
    batch's on every rank, is reported as the group's share of it."""
    logits, aux = forward(cfg, params, batch)
    logits = logits.to(torch.float32)
    if cfg.causal:
        targets = batch.get("targets")
        if targets is None:
            targets = batch["tokens"][:, 1:]
            if cfg.modality == "vlm":
                logits = logits[:, -batch["tokens"].shape[1]:-1]
            else:
                logits = logits[:, :-1]
        else:
            logits = logits[:, -(targets.shape[1] + 1):-1]
    else:
        targets = batch["targets"]
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    group = partitioning.fsdp_group()
    if mask is None:
        loss = nll.mean()
        if group is not None:
            loss = loss / group.size
    else:
        mask = mask.to(torch.float32)
        denom = mask.sum()
        if group is not None:
            denom = group.all_reduce(denom)
        loss = (nll * mask).sum() / (denom + 1e-6)
    total = loss + aux_weight * (aux["load_balance_loss"]
                                 + 0.1 * aux["router_z_loss"])
    dropped = aux["dropped_fraction"]
    if group is not None:
        dropped = dropped / group.size
    return total, {"ce_loss": loss,
                   "load_balance_loss": aux["load_balance_loss"],
                   "dropped_fraction": dropped,
                   "total_loss": total}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device) -> list:
    return transformer.init_run_caches(cfg, batch, max_len, dtype, device)


def cache_axes(cfg: ModelConfig) -> list:
    return transformer.run_cache_axes(cfg)


def prefill(cfg: ModelConfig, params: dict, inputs: dict, caches: list
            ) -> Tuple[torch.Tensor, list]:
    """Process the full prompt; returns (last-token logits (B, V) fp32,
    caches), the caches written in place."""
    x = embed_inputs(cfg, params, inputs)
    x, caches = transformer.prefill_runs(cfg, params["blocks"], x,
                                         _positions(x), caches)
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
