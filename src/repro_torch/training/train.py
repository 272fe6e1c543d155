"""Training step: gradients through the model + AdamW, with optional
microbatch gradient accumulation (port of ``repro.training.train``).

Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves: each step differentiates fresh leaf views of the parameters, so
the caller's tensors never carry autograd state.  On the card, attention
runs forward and backward through B3's kernels
(``kernels.flash_attention.FlashAttentionFn``) and Mamba2's SSD scan
through B7's (``kernels.ssd_scan.SsdFn``); every other kernel is a
serving kernel with no backward and raises under grad
(``kernels.ops``).  Microbatches accumulate in fp32 and their metrics
are averaged, as the reference's ``jax.lax.scan`` does.

On a mesh (``partitioning.mesh_context`` and the parameters' specs,
``launch.shardings.train_param_specs``) a rank holds its blocks of the
parameters and moments and its rows of the batch.  A step all-gathers
every leaf that the batch axes shard over the FSDP group (the ranks
that share its other coordinates), so that the model code sees its
model-axis blocks alone and keeps its shape-driven choice of local
against whole leaves; differentiates that tree; then reduce-scatters
each such leaf's gradient over the FSDP group and all-reduces the
others' over it.  Each rank's loss is its share of the loss over the
whole batch (``models.model.lm_loss``), so the sums are the whole
batch's gradients, and the loss and metrics come out the same on every
rank.  The whole tree is gathered once a step.  A Mamba2 leaf whose
model-axis block is head-aligned (``partitioning.IndexSpec``: its
heads' columns with B and C whole) is gathered and scattered over the
FSDP group along its own "fsdp" dimension, the model block untouched.

With ``microbatches`` n > 1 on a split batch, a rank's rows are first
exchanged so that it holds its block of every one of the reference's
microbatches (``_reference_micro_rows``): the reference's microbatch i
is rows [i B/n, (i+1) B/n) of the whole batch of B rows, and rank r of
the R in the FSDP group keeps rows i B/n + r B/(n R) onwards, B/(n R)
of them, of each, in microbatch order.  So microbatch i's mask sum
(``lm_loss``), dispatch groups, capacity and load-balance loss
(``moe.whole_routes``) are the reference's microbatch i's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import lm_loss
from repro_torch.optim import OptimizerConfig, OptState, adamw_update
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1          # grad-accum splits of the global batch
    aux_weight: float = 0.01


def _split_micro(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B//n, ...) for every leaf."""
    return {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
            for k, x in batch.items()}


def _value_and_grad(cfg: ModelConfig, tcfg: TrainConfig, params,
                    batch: dict):
    """(loss, metrics, grads) of one batch; a leaf the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = lm_loss(cfg, live, batch, aux_weight=tcfg.aux_weight)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, grads))


def loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params,
                   batch: dict, specs=None):
    """Grad through the model, with microbatch accumulation if asked.
    With ``specs`` (on the active mesh, see the module docstring)
    ``params`` are this rank's blocks and ``batch`` its rows; the
    gradients come back as blocks of the whole batch's, and the loss and
    metrics as the whole batch's."""
    if specs is not None:
        return _mesh_loss_and_grads(cfg, tcfg, params, batch, specs)
    return _local_loss_and_grads(cfg, tcfg, params, batch)


def _local_loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params,
                          batch: dict):
    if tcfg.microbatches <= 1:
        return _value_and_grad(cfg, tcfg, params, batch)

    micro = _split_micro(batch, tcfg.microbatches)
    acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    acc_l = None
    metricses = []
    for i in range(tcfg.microbatches):
        loss, metrics, grads = _value_and_grad(
            cfg, tcfg, params, {k: v[i] for k, v in micro.items()})
        acc_g = tree_map(lambda a, g: a + g.to(torch.float32), acc_g, grads)
        acc_l = loss.to(torch.float32) if acc_l is None else acc_l + loss
        metricses.append(metrics)
    inv = 1.0 / tcfg.microbatches
    grads = tree_map(lambda g: g * inv, acc_g)
    metrics = {k: torch.stack([m[k] for m in metricses]).mean()
               for k in metricses[0]}
    return acc_l * inv, metrics, grads


def _reference_micro_rows(batch: dict, group, n: int, r: int) -> dict:
    """This rank's block of each of the reference's ``n`` microbatches,
    in microbatch order, from its block ``r`` of the whole batch's rows:
    every leaf all-gathered over the FSDP ``group`` of R ranks along its
    rows (the whole batch, B rows in ``fsdp_index`` order), then rows
    i B/n + r B/(n R) .. + B/(n R) of it for each microbatch i.  Each
    rank receives (R - 1)/R of the batch's bytes once a step: of 8 x 128
    int32 token ids 4 KB, of paligemma's fp32 patches at the launcher's
    8 rows (256 x 1152 a row) 9.4 MB."""
    size = group.size
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(
            f"a batch of {rows * size} rows does not split into {n} "
            f"microbatches of {size} ranks' equal blocks ({n * size})")
    with torch.no_grad():
        return {k: group.all_gather(x, 0).unflatten(0, (n, size, rows // n))
                [:, r].flatten(0, 1) for k, x in batch.items()}


def _mesh_loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params,
                         batch: dict, specs):
    mesh = partitioning.active_mesh()
    if mesh is None:
        raise RuntimeError("a step over parameter blocks (specs given) "
                           "needs their mesh active "
                           "(partitioning.mesh_context)")
    group = mesh.group("fsdp")
    if group is not None and tcfg.microbatches > 1:
        batch = _reference_micro_rows(batch, group, tcfg.microbatches,
                                      mesh.fsdp_index())
    dims = [partitioning.fsdp_dim(spec)
            for spec in partitioning.spec_leaves(specs, params)]
    local = leaves(params)
    if group is not None:
        with torch.no_grad():
            local = [x if d is None else group.all_gather(x, d)
                     for x, d in zip(local, dims)]
    loss, metrics, grads = _local_loss_and_grads(
        cfg, tcfg, unflatten_like(params, local), batch)
    del local
    if group is None:
        return loss, metrics, grads
    with torch.no_grad():
        grads = unflatten_like(params, [
            group.all_reduce(g) if d is None else group.reduce_scatter(g, d)
            for g, d in zip(leaves(grads), dims)])
        # the ranks' shares summed (``lm_loss``)
        names = sorted(metrics)
        total = group.all_reduce(torch.stack(
            [loss.to(torch.float32)]
            + [metrics[k].to(torch.float32) for k in names]))
        metrics = {k: total[i + 1] for i, k in enumerate(names)}
    return total[0], metrics, grads


def train_step(cfg: ModelConfig, tcfg: TrainConfig, params,
               opt_state: OptState, batch: dict, specs=None):
    """One optimizer step.  Returns (params, opt_state, metrics).  On a
    mesh ``specs`` are the parameters' (and the moments'), ``params`` and
    ``opt_state`` this rank's blocks and ``batch`` its rows (the module
    docstring)."""
    loss, metrics, grads = loss_and_grads(cfg, tcfg, params, batch, specs)
    params, opt_state, opt_metrics = adamw_update(
        tcfg.optimizer, params, grads, opt_state, specs)
    metrics = dict(metrics)
    metrics.update(opt_metrics)
    metrics["loss"] = loss
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Closure over the configs: ``step(params, opt_state, batch)``."""
    def step(params, opt_state, batch):
        return train_step(cfg, tcfg, params, opt_state, batch)

    return step
