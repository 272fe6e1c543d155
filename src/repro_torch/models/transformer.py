"""Block composition over runs of layers (port of
``repro.models.transformer``: dense "A", MoE "M", Mamba2 "S" and
zamba2's shared "G" blocks, through the full-sequence ``apply_runs`` and
the serving ``prefill_runs`` / ``decode_runs``).

As in the reference, the layer pattern splits into runs of one block
kind and each run's parameters and caches are stacked on a leading
layer axis; the JAX ``scan`` over that axis becomes a Python loop over
per-layer views, which the blocks write in place.  A "G" position is a
run of its own: its parameter entry is ``{}`` and every G position
applies ``blocks["shared"]`` as an "A" block, with a KV cache of its
own (a run of leading size 1).  With ``cfg.remat`` the full-sequence
driver checkpoints each block (the reference's ``_maybe_remat``): its
activations are recomputed in the backward pass, so a block's kernels
launch twice a training step.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import (attention, layers, mamba2, mlp, moe,
                                partitioning)
from repro_torch.models.config import ModelConfig


def pattern_runs(pattern: str) -> List[Tuple[str, int]]:
    runs: List[Tuple[str, int]] = []
    for kind in pattern:
        if runs and runs[-1][0] == kind and kind != "G":
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


KINDS = ("A", "M", "S", "G")
NORMS = ("rmsnorm", "layernorm")
MLPS = ("silu", "gelu", "geglu")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a block kind, norm or MLP the reference does not have
    either (``KINDS``, ``NORMS``, ``MLPS``).  Every modality (text, and
    the audio and vlm frontends) is ported."""
    other = set(cfg.layer_pattern) - set(KINDS)
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(other)} are not ported "
            f"(kinds {KINDS})")
    if cfg.norm_type not in NORMS or cfg.mlp_activation not in MLPS:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.norm_type} / {cfg.mlp_activation} is not "
            f"ported (norms {NORMS}, MLPs {MLPS})")


def check_model_axis(cfg: ModelConfig, model: int) -> None:
    """Raise unless ``cfg`` runs on a ``model``-way model axis: the place
    a family's check of the model axis goes.  Every family runs: the
    dense decoders (heads, MLP and vocabulary over the axis, or the cache
    length where it does not divide the kv-heads), the MoE layer (experts
    or their hidden units), the vlm and audio frontends, and Mamba2's "S"
    blocks, at a rank's block of the SSM heads where the axis divides
    them (``mamba2.ssm_block_layout``), else whole on every rank."""
    del cfg, model


def check_batch_axes(cfg: ModelConfig, batch: int) -> None:
    """Raise unless ``cfg`` runs with its batch split ``batch`` ways over
    the batch axes ("pod", "data"), each rank's rows the reference's rows
    of the whole batch: the place a family's check of the batch axes goes.
    Every family runs; the MoE layer's groups, capacity and losses follow
    the whole batch through its routing gather (``moe.moe_block``)."""
    del cfg, batch


def _layer_views(tree, count: int) -> list:
    """All ``count`` layers of a stacked parameter or cache tree, as
    views from one ``unbind`` a leaf (a cache is written in place through
    them).  Autograd then stacks the layers' gradients into each leaf in
    one op; indexing layer by layer would build a zero-filled gradient of
    the whole stacked leaf for every layer and add them up, which at full
    depth is most of a training step's elementwise time."""
    if isinstance(tree, dict):
        # a layer's caches keep the run's layout (``attention.RingBlock``)
        per = {k: _layer_views(v, count) for k, v in tree.items()}
        return [type(tree)({k: per[k][i] for k in per})
                for i in range(count)]
    return tree.unbind(0)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_into(stacked, tree, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_into(stacked[k], v, i)
    else:
        stacked[i].copy_(tree)


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    if kind == "S":
        return {"norm": layers.norm_axes(cfg),
                "ssm": mamba2.mamba2_axes(cfg)}
    ax = {"norm1": layers.norm_axes(cfg),
          "attn": attention.attention_axes(cfg),
          "norm2": layers.norm_axes(cfg)}
    ax["moe" if kind == "M" else "mlp"] = (
        moe.moe_axes(cfg) if kind == "M" else mlp.mlp_axes(cfg))
    return ax


def blocks_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_blocks``' tree: each run's block axes
    behind its stacked leading "layers" axis."""
    out: dict = {"runs": [
        {} if kind == "G" else
        _map(lambda t: ("layers",) + t, _block_axes(cfg, kind))
        for kind, _ in pattern_runs(cfg.layer_pattern)]}
    if "G" in cfg.layer_pattern:
        out["shared"] = _block_axes(cfg, "A")
    return out


def run_cache_axes(cfg: ModelConfig) -> list:
    return [_map(lambda t: ("layers",) + t,
                 mamba2.ssm_cache_axes() if kind == "S"
                 else attention.kv_cache_axes())
            for kind, _ in pattern_runs(cfg.layer_pattern)]


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype,
                device) -> dict:
    if kind == "S":
        return {"norm": layers.init_norm(cfg, dtype, device),
                "ssm": mamba2.init_mamba2(cfg, gen, dtype, device)}
    p = {"norm1": layers.init_norm(cfg, dtype, device),
         "attn": attention.init_attention(cfg, gen, dtype, device),
         "norm2": layers.init_norm(cfg, dtype, device)}
    if kind == "M":
        p["moe"] = moe.init_moe(cfg, gen, dtype, device)
    else:
        p["mlp"] = mlp.init_mlp(cfg, gen, dtype, device)
    return p


def _init_run(cfg: ModelConfig, kind: str, count: int,
              gen: torch.Generator, dtype, device) -> dict:
    """A run's parameters stacked on a leading layer axis, drawn layer
    by layer into one buffer a leaf: the run is never held twice (a
    full-depth MoE run is most of the card's memory)."""
    first = _init_block(cfg, kind, gen, dtype, device)
    stacked = _map(lambda t: t.new_empty((count,) + tuple(t.shape)), first)
    _copy_into(stacked, first, 0)
    del first
    for i in range(1, count):
        _copy_into(stacked, _init_block(cfg, kind, gen, dtype, device), i)
    return stacked


def init_blocks(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> dict:
    """{"runs": [stacked params per run, {} at each G run], "shared": the
    G blocks' one "A" parameter set (only when the pattern has a G)},
    the reference's tree."""
    check_ported(cfg)
    out: dict = {"runs": [
        {} if kind == "G" else _init_run(cfg, kind, count, gen, dtype,
                                         device)
        for kind, count in pattern_runs(cfg.layer_pattern)]}
    if "G" in cfg.layer_pattern:
        out["shared"] = _init_block(cfg, "A", gen, dtype, device)
    return out


def init_run_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> list:
    """One cache dict per run, stacked on the run's layer axis: a ring
    KV cache for "A", "M" and each "G" position, the conv window and
    fp32 state for "S".  On the active mesh's model axis a rank's KV
    caches follow the reference's cache rules: its block of the kv-heads
    where the axis divides them, else its block of the ring slots where
    the axis divides the ring width, else the whole ring
    (``attention.init_kv_cache``), and a rank's SSM caches its heads' and
    channels' where the axis divides the SSM heads
    (``mamba2.init_ssm_cache``)."""
    check_ported(cfg)
    model = partitioning.axis_size("model")
    check_model_axis(cfg, model)
    return [mamba2.init_ssm_cache(cfg, batch, dtype, device, count, model)
            if kind == "S" else
            attention.init_kv_cache(cfg, batch, max_len, dtype, device, count,
                                    model)
            for kind, count in pattern_runs(cfg.layer_pattern)]


def _ffn(cfg: ModelConfig, kind: str, p: dict, h):
    """The block's second half: (y, aux) for "M", (y, None) else."""
    if kind == "M":
        return moe.moe_block(cfg, p["moe"], h)
    return mlp.mlp_block(cfg, p["mlp"], h), None


def _runs(cfg: ModelConfig, blocks: dict):
    """(kind, count, stacked params) of every run; a G run applies the
    shared parameters as an "A" block of a one-layer run."""
    for (kind, count), run_p in zip(pattern_runs(cfg.layer_pattern),
                                    blocks["runs"]):
        if kind == "G":
            yield "A", count, _map(lambda t: t[None], blocks["shared"])
        else:
            yield kind, count, run_p


def block_apply(cfg: ModelConfig, kind: str, p: dict, x, positions):
    """Full-sequence block.  Returns (x, aux): aux is the MoE block's
    statistics, None for every other kind."""
    if kind == "S":
        return x + mamba2.mamba2_block(
            cfg, p["ssm"], layers.apply_norm(cfg, p["norm"], x)), None
    x = x + attention.attention_block(
        cfg, p["attn"], layers.apply_norm(cfg, p["norm1"], x), positions)
    y, aux = _ffn(cfg, kind, p, layers.apply_norm(cfg, p["norm2"], x))
    return x + y, aux


AUX = ("load_balance_loss", "router_z_loss", "dropped_fraction")


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` checkpointed (recomputed in the backward pass) when
    ``cfg.remat``, as ``jax.checkpoint`` in the reference.  On a model
    axis the recomputed forward issues its collectives again; every rank
    recomputes in the same order, so they pair up, at twice the forward's
    model-axis bytes."""
    if not cfg.remat:
        return fn

    def remat(*args):
        # the backward recomputes on the autograd engine's thread (a
        # CUDA device's own thread), where no mesh context is active:
        # recompute under the forward's mesh
        mesh = partitioning.active_mesh()

        def run(*inner):
            with partitioning.mesh_context(mesh):
                return fn(*inner)

        return torch.utils.checkpoint.checkpoint(run, *args,
                                                 use_reentrant=False)

    return remat


def apply_runs(cfg: ModelConfig, blocks: dict, x, positions):
    """Forward through all runs (train / plain inference).  Returns
    (x, aux): as the reference, each MoE statistic summed over the
    layers (zero without "M" blocks)."""
    total = {name: torch.zeros((), dtype=torch.float32, device=x.device)
             for name in AUX}
    apply = _maybe_remat(cfg, block_apply)
    for kind, count, run_p in _runs(cfg, blocks):
        auxs = []
        for layer_p in _layer_views(run_p, count):
            x, aux = apply(cfg, kind, layer_p, x, positions)
            auxs.append(aux)
        if kind == "M":
            total = {name: total[name] + torch.stack(
                [a[name] for a in auxs]).sum() for name in AUX}
    return x, total


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
    y, _ = _ffn(cfg, kind, p, layers.apply_norm(cfg, p["norm2"], x))
    return x + y, cache


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
    # a free slot's stream enters the MoE router too, and competes for
    # expert capacity, as in the reference
    y, _ = _ffn(cfg, kind, p, layers.apply_norm(cfg, p["norm2"], x))
    return x + y, cache


def prefill_runs(cfg: ModelConfig, blocks: dict, x, positions, caches):
    for (kind, count, run_p), cache in zip(_runs(cfg, blocks), caches):
        for layer_p, layer_c in zip(_layer_views(run_p, count),
                                    _layer_views(cache, count)):
            x, _ = block_prefill(cfg, kind, layer_p, x, positions, layer_c)
    return x, caches


def decode_runs(cfg: ModelConfig, blocks: dict, x, pos, caches, live=None):
    for (kind, count, run_p), cache in zip(_runs(cfg, blocks), caches):
        for layer_p, layer_c in zip(_layer_views(run_p, count),
                                    _layer_views(cache, count)):
            x, _ = block_decode(cfg, kind, layer_p, x, pos, layer_c,
                                live=live)
    return x, caches
