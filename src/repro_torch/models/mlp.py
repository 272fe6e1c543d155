"""Dense SwiGLU MLP (port of ``repro.models.mlp``; the GELU variants of
the encoder configurations are not ported yet)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5
    return {"w_gate": layers.dense_init(gen, d, f, dtype, device),
            "w_in": layers.dense_init(gen, d, f, dtype, device),
            "w_out": layers.dense_init(gen, f, d, dtype, device, out_scale)}


def mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
