"""Logical axes to per-rank blocks (port of ``repro.launch.shardings``).

Each function returns specs where the reference returns
``NamedSharding``s: a spec is a tuple with one entry a dimension, None
(whole), a mesh axis name or a tuple of them (the entries of the
reference's ``PartitionSpec``).  ``local_shard`` takes the place of
``jax.device_put``: it slices a whole tree to this rank's block of each
leaf.  The specs of Mamba2's "S" leaves and caches are the reference's
with the head-aligned layout beneath them (``head_aligned``:
``partitioning.IndexSpec``), which ``local_shard``, ``gather_leaf`` and
through them the checkpoints read.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import mamba2, partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_axes, logical_axes
from repro_torch.models.transformer import (check_batch_axes,
                                            check_model_axis, pattern_runs)
from repro_torch.optim import opt_state_axes


def tree_shardings(mesh, axes_tree, shapes_tree,
                   rules: Optional[dict] = None):
    """Map a logical-axes tree and the matching tree of tensors (or
    shapes) to specs."""
    return partitioning.param_sharding(mesh, axes_tree, shapes_tree, rules)


def batch_sharding(mesh, ndim: int,
                   batch_size: Optional[int] = None) -> tuple:
    """Shard the leading (batch) axis over ("worker", "pod", "data").

    Falls back to the largest divisible suffix of the axes (dropping
    "worker" first, then "pod") and to replication for batch=1, as the
    reference does: pjit rejects shardings that do not divide.
    """
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    axes = tuple(a for a in ("worker", "pod", "data") if a in sizes)
    if batch_size is not None:
        while axes and batch_size % math.prod(sizes[a] for a in axes):
            axes = axes[1:]
    if not axes:
        return (None,) * ndim
    return (axes if len(axes) > 1 else axes[0],) + (None,) * (ndim - 1)


def batch_tree_shardings(mesh, tree):
    """``batch_sharding`` of every tensor (or shape) of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: batch_tree_shardings(mesh, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [batch_tree_shardings(mesh, v) for v in tree]
    shape = tuple(getattr(tree, "shape", tree))
    return batch_sharding(mesh, len(shape), shape[0])


def replicated(mesh) -> tuple:
    """The whole value on every rank (``PartitionSpec()``)."""
    return ()


def cache_rules(mesh, cfg: ModelConfig) -> Optional[dict]:
    """KV-cache sharding policy: heads over "model" when divisible, else
    cache length over "model" (flash-decode cache split)."""
    model = dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)
    if cfg.num_kv_heads and cfg.num_kv_heads % model == 0:
        return None                     # default: kv_heads -> model
    rules = dict(partitioning.DEFAULT_RULES)
    rules["kv_heads"] = None
    rules["kv_seq"] = "model"
    return rules


def cache_shardings(mesh, cfg: ModelConfig, caches,
                    rules: Optional[dict] = None):
    """Specs of the per-run serving caches (``models.model.cache_axes``)
    under ``cache_rules``: ``local_shard`` of the one-rank caches under
    them holds the values that ``models.model.init_caches`` allocates on
    each rank (a block of the kv-heads, of the ring slots, or the whole
    cache; Mamba2's the rank's heads and channels, ``head_aligned``).  A
    block of the ring slots comes out a plain dict, which the attention
    refuses: its layout is the type ``attention.RingBlock``, which a spec
    does not carry, so wrap it in one."""
    return head_aligned(mesh, cfg, tree_shardings(
        mesh, cache_axes(cfg), caches, rules or cache_rules(mesh, cfg)),
        cache=True)


def head_aligned(mesh, cfg: ModelConfig, runs: list,
                 cache: bool = False) -> list:
    """The specs of each run (a list: the parameters' ``blocks.runs``,
    or with ``cache`` the caches) with every "S" leaf's replaced by the
    layout a model-axis rank holds (``mamba2.head_spec``), in place;
    returns ``runs``."""
    model = dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)
    for (kind, _), run in zip(pattern_runs(cfg.layer_pattern), runs):
        if kind == "S":
            leaves = run if cache else run["ssm"]
            for name, spec in leaves.items():
                leaves[name] = mamba2.head_spec(cfg, model, name, spec,
                                                cache)
    return runs


def _param_specs(mesh, cfg: ModelConfig, specs: dict) -> dict:
    head_aligned(mesh, cfg, specs["blocks"]["runs"])
    return specs


def serving_param_specs(mesh, cfg: ModelConfig, params) -> dict:
    """The serving forward's parameter specs: ``logical_axes`` on
    ``mesh`` with the weights whole over the data and pod axes (the
    reference's FSDP gather of weights belongs to the training step,
    ``train_param_specs``), so only the model axis splits them.  Raises
    for a configuration the model axis does not run
    (``check_model_axis``)."""
    check_model_axis(cfg, dict(zip(mesh.axis_names, mesh.shape))
                     .get("model", 1))
    rules = dict(partitioning.DEFAULT_RULES, fsdp=None)
    return _param_specs(mesh, cfg, tree_shardings(mesh, logical_axes(cfg),
                                                  params, rules))


def _check_train(mesh, cfg: ModelConfig) -> None:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    check_model_axis(cfg, sizes.get("model", 1))
    check_batch_axes(cfg, math.prod(sizes.get(a, 1)
                                    for a in partitioning.BATCH_AXES))


def train_param_specs(mesh, cfg: ModelConfig, params) -> dict:
    """The training step's parameter specs: ``logical_axes`` on ``mesh``
    under ``DEFAULT_RULES``, "fsdp" on, as the reference's launcher
    shards them: the model axis splits heads, MLP and vocabulary, and the
    batch axes ("pod", "data") jointly split each weight's "fsdp"
    dimension where they divide it.  Raises for a configuration the
    mesh does not train (``check_model_axis``, ``check_batch_axes``)."""
    _check_train(mesh, cfg)
    return _param_specs(mesh, cfg, tree_shardings(mesh, logical_axes(cfg),
                                                  params))


def train_opt_specs(mesh, cfg: ModelConfig, opt_state):
    """The optimizer state's specs (``optim.opt_state_axes``): each
    moment the specs of its parameter, the step counter whole."""
    _check_train(mesh, cfg)
    specs = tree_shardings(mesh, opt_state_axes(logical_axes(cfg)),
                           opt_state)
    for moments in (specs.mu, specs.nu):
        _param_specs(mesh, cfg, moments)
    return specs


@torch.no_grad()
def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block ``x`` under ``spec``: each
    split dimension all-gathered over its group (the batch axes' over the
    "fsdp" group), an ``IndexSpec``'s dimension put back in the whole
    leaf's order (each position once).  Every rank of the mesh must call
    it."""
    for dim, entry in enumerate(spec):
        if dim == getattr(spec, "dim", None):
            if spec.index is not None:
                index = torch.cat(spec.index)
                parts = mesh.group("model").all_gather(x, dim)
                shape = list(x.shape)
                shape[dim] = int(index.max()) + 1
                x = x.new_empty(shape).index_copy_(dim, index.to(x.device),
                                                   parts)
            continue
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if set(axes) <= set(partitioning.BATCH_AXES):
            name = "fsdp"
        elif len(axes) == 1:
            name = axes[0]
        else:
            raise ValueError(f"spec {spec}: no group gathers {axes}")
        group = mesh.group(name)
        if group is not None:
            x = group.all_gather(x, dim)
    return x


def _block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: along a dimension
    sharded over axes (a, b, ...) the block index is the rank's
    coordinates over them, row-major, as a ``NamedSharding`` places
    them; along an ``IndexSpec``'s dimension its positions at the rank's
    model coordinate, or the whole."""
    out = x
    for dim, entry in enumerate(spec):
        if dim == getattr(spec, "dim", None):
            if spec.index is not None:
                out = out.index_select(dim, spec.index[
                    mesh.coord("model")].to(x.device))
            continue
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n, idx = 1, 0
        for a in axes:
            n, idx = n * mesh.size(a), idx * mesh.size(a) + mesh.coord(a)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"cannot split dimension {dim} of "
                             f"{tuple(x.shape)} over {axes}")
        step = x.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    # a copy of the block alone, so the whole leaf can be freed
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def local_shard(tree, specs, mesh):
    """This rank's block of each leaf of ``tree`` (dicts, lists and
    NamedTuples such as ``optim.OptState`` of tensors) under the matching
    tree of ``specs``: the port's ``device_put``.  A whole leaf is passed
    through, a split one copied."""
    if isinstance(tree, dict):
        return {k: local_shard(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [local_shard(v, s, mesh) for v, s in zip(tree, specs)]
    if hasattr(tree, "_fields"):
        return type(tree)(*(local_shard(v, s, mesh)
                            for v, s in zip(tree, specs)))
    return _block(tree, specs, mesh)
