"""Block composition over runs of layers (port of
``repro.models.transformer``: dense "A" and Mamba2 "S" runs, through the
full-sequence ``apply_runs`` and the serving ``prefill_runs`` /
``decode_runs``).

As in the reference, the layer pattern splits into runs of one block
kind and each run's parameters and caches are stacked on a leading
layer axis; the JAX ``scan`` over that axis becomes a Python loop over
per-layer views, which the blocks write in place.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.models import attention, layers, mamba2, mlp
from repro_torch.models.config import ModelConfig


def pattern_runs(pattern: str) -> List[Tuple[str, int]]:
    runs: List[Tuple[str, int]] = []
    for kind in pattern:
        if runs and runs[-1][0] == kind and kind != "G":
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


NORMS = ("rmsnorm", "layernorm")
MLPS = ("silu", "gelu", "geglu")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for what the port does not cover yet: blocks other than
    dense "A" and Mamba2 "S", and non-text frontends; a norm or MLP the
    reference does not have either (``NORMS``, ``MLPS``) raises too."""
    other = set(cfg.layer_pattern) - {"A", "S"}
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(other)} are not ported yet "
            "(dense 'A' and Mamba2 'S' blocks only)")
    if (cfg.norm_type not in NORMS or cfg.mlp_activation not in MLPS
            or cfg.modality != "text"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.norm_type} / {cfg.mlp_activation} / "
            f"{cfg.modality} is not ported yet (norms {NORMS}, MLPs "
            f"{MLPS}, text inputs)")


def _layer_view(tree, i: int):
    """The i-th layer of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype,
                device) -> dict:
    if kind == "S":
        return {"norm": layers.init_norm(cfg, dtype, device),
                "ssm": mamba2.init_mamba2(cfg, gen, dtype, device)}
    return {"norm1": layers.init_norm(cfg, dtype, device),
            "attn": attention.init_attention(cfg, gen, dtype, device),
            "norm2": layers.init_norm(cfg, dtype, device),
            "mlp": mlp.init_mlp(cfg, gen, dtype, device)}


def init_blocks(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> dict:
    check_ported(cfg)
    return {"runs": [
        _stack([_init_block(cfg, kind, gen, dtype, device)
                for _ in range(count)])
        for kind, count in pattern_runs(cfg.layer_pattern)]}


def init_run_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> list:
    """One cache dict per run, stacked on the run's layer axis: a ring
    KV cache for "A", the conv window and fp32 state for "S"."""
    check_ported(cfg)
    return [mamba2.init_ssm_cache(cfg, batch, dtype, device, count)
            if kind == "S" else
            attention.init_kv_cache(cfg, batch, max_len, dtype, device, count)
            for kind, count in pattern_runs(cfg.layer_pattern)]


def block_apply(cfg: ModelConfig, kind: str, p: dict, x, positions):
    """Full-sequence block.  Returns x: no ported block has the
    reference's per-block aux (only "M" blocks make one)."""
    if kind == "S":
        return x + mamba2.mamba2_block(
            cfg, p["ssm"], layers.apply_norm(cfg, p["norm"], x))
    x = x + attention.attention_block(
        cfg, p["attn"], layers.apply_norm(cfg, p["norm1"], x), positions)
    return x + mlp.mlp_block(cfg, p["mlp"],
                             layers.apply_norm(cfg, p["norm2"], x))


def apply_runs(cfg: ModelConfig, blocks: dict, x, positions):
    """Forward through all runs (train / plain inference).  Returns
    (x, aux): the reference's sum of the blocks' MoE statistics, all zero
    while no "M" block is ported."""
    for (kind, count), run_p in zip(pattern_runs(cfg.layer_pattern),
                                    blocks["runs"]):
        for i in range(count):
            x = block_apply(cfg, kind, _layer_view(run_p, i), x, positions)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"load_balance_loss": zero, "router_z_loss": zero,
               "dropped_fraction": zero}


def block_prefill(cfg: ModelConfig, kind: str, p: dict, x, positions,
                  cache):
    if kind == "S":
        y, cache = mamba2.mamba2_prefill(
            cfg, p["ssm"], layers.apply_norm(cfg, p["norm"], x), cache)
        return x + y, cache
    att, cache = attention.attention_prefill(
        cfg, p["attn"], layers.apply_norm(cfg, p["norm1"], x), positions,
        cache)
    x = x + att
    return x + mlp.mlp_block(cfg, p["mlp"],
                             layers.apply_norm(cfg, p["norm2"], x)), cache


def block_decode(cfg: ModelConfig, kind: str, p: dict, x, pos, cache,
                 live=None):
    if kind == "S":
        # the SSM state has no positions: ``pos`` and ``live`` gate
        # attention only; a free slot's state steps on don't-care tokens
        # and its rows are masked downstream, as in the reference
        y, cache = mamba2.mamba2_decode(
            cfg, p["ssm"], layers.apply_norm(cfg, p["norm"], x), cache)
        return x + y, cache
    att, cache = attention.attention_decode(
        cfg, p["attn"], layers.apply_norm(cfg, p["norm1"], x), pos, cache,
        live=live)
    x = x + att
    return x + mlp.mlp_block(cfg, p["mlp"],
                             layers.apply_norm(cfg, p["norm2"], x)), cache


def prefill_runs(cfg: ModelConfig, blocks: dict, x, positions, caches):
    for (kind, count), run_p, cache in zip(pattern_runs(cfg.layer_pattern),
                                           blocks["runs"], caches):
        for i in range(count):
            x, _ = block_prefill(cfg, kind, _layer_view(run_p, i), x,
                                 positions, _layer_view(cache, i))
    return x, caches


def decode_runs(cfg: ModelConfig, blocks: dict, x, pos, caches, live=None):
    for (kind, count), run_p, cache in zip(pattern_runs(cfg.layer_pattern),
                                           blocks["runs"], caches):
        for i in range(count):
            x, _ = block_decode(cfg, kind, _layer_view(run_p, i), x, pos,
                                _layer_view(cache, i), live=live)
    return x, caches
