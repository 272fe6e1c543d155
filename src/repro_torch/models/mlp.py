"""Dense MLP: SwiGLU (llama family), GELU (hubert / encoder style) or
GeGLU (gemma / paligemma); port of ``repro.models.mlp``.

``jax.nn.gelu`` defaults to the tanh approximation, so the port's GELU is
``F.gelu(..., approximate="tanh")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers, partitioning
from repro_torch.models.config import ModelConfig


def mlp_axes(cfg: ModelConfig) -> dict:
    if cfg.mlp_activation == "gelu":
        return {"w_in": ("fsdp", "ffn"), "w_out": ("ffn", "fsdp")}
    return {"w_gate": ("fsdp", "ffn"), "w_in": ("fsdp", "ffn"),
            "w_out": ("ffn", "fsdp")}


def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5
    if cfg.mlp_activation == "gelu":
        return {"w_in": layers.dense_init(gen, d, f, dtype, device),
                "w_out": layers.dense_init(gen, f, d, dtype, device,
                                           out_scale)}
    return {"w_gate": layers.dense_init(gen, d, f, dtype, device),
            "w_in": layers.dense_init(gen, d, f, dtype, device),
            "w_out": layers.dense_init(gen, f, d, dtype, device, out_scale)}


def mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP; on a model-axis rank's block of the hidden units ``x``
    enters the block through ``ModelGroup.enter`` (its gradient is
    summed over the axis) and the output is a partial sum, all-reduced
    over it."""
    local = p["w_out"].shape[0] < cfg.d_ff
    if local:
        x = partitioning.model_group().enter(x)
    if cfg.mlp_activation == "gelu":
        h = F.gelu(x @ p["w_in"], approximate="tanh")
    elif cfg.mlp_activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_in"])
    else:                                 # SwiGLU
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    out = h @ p["w_out"]
    return partitioning.model_group().all_reduce(out) if local else out
