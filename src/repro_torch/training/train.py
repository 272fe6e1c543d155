"""Training step: gradients through the model + AdamW, with optional
microbatch gradient accumulation (port of ``repro.training.train``).

Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves: each step differentiates fresh leaf views of the parameters, so
the caller's tensors never carry autograd state.  On the card, attention
runs forward and backward through B3's kernels
(``kernels.flash_attention.FlashAttentionFn``); every other kernel has no
backward and raises under grad (``kernels.ops``), which keeps Mamba2's
SSD scan off the card's training path until ROADMAP A12.  Microbatches
accumulate in fp32 and their metrics are averaged, as the reference's
``jax.lax.scan`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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
                   batch: dict):
    """Grad through the model, with microbatch accumulation if asked."""
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


def train_step(cfg: ModelConfig, tcfg: TrainConfig, params,
               opt_state: OptState, batch: dict):
    """One optimizer step.  Returns (params, opt_state, metrics)."""
    loss, metrics, grads = loss_and_grads(cfg, tcfg, params, batch)
    params, opt_state, opt_metrics = adamw_update(
        tcfg.optimizer, params, grads, opt_state)
    metrics = dict(metrics)
    metrics.update(opt_metrics)
    metrics["loss"] = loss
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Closure over the configs: ``step(params, opt_state, batch)``."""
    def step(params, opt_state, batch):
        return train_step(cfg, tcfg, params, opt_state, batch)

    return step
