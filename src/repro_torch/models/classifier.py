"""Small MLP classifier (port of ``repro.models.classifier``): the
stand-in for the paper's CNN image classifiers, and ParM's parity-model
architecture, which ParM trains as a network of the base model's family.

Parameters are drawn from a ``torch.Generator`` (the reference draws
from ``jax.random``, so the two differ for one seed); ``train_classifier``
and ``train_parity_model`` also take initial parameters, so that both
packages can start from the same values.  Minibatch indices come from
``np.random.RandomState(seed)``, as in the reference, so both draw the
same minibatches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.optim import OptimizerConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    dim: int = 64
    hidden: int = 256
    depth: int = 2
    num_classes: int = 10


def init_classifier(cfg: ClassifierConfig, generator: torch.Generator,
                    device=None) -> dict:
    """{"w{i}": N(0, 1/fan_in), "b{i}": 0} for each layer, fp32."""
    device = resolve_device(device)
    params = {}
    dims = [cfg.dim] + [cfg.hidden] * cfg.depth + [cfg.num_classes]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.randn((a, b), generator=generator,
                                      device=device) / math.sqrt(a)
        params[f"b{i}"] = torch.zeros((b,), device=device)
    return params


def classifier_apply(cfg: ClassifierConfig, params: dict,
                     x: torch.Tensor) -> torch.Tensor:
    """Logits; the hidden activation is ``jax.nn.gelu``'s default, the tanh
    approximation."""
    h = x
    for i in range(cfg.depth):
        h = F.gelu(h @ params[f"w{i}"] + params[f"b{i}"], approximate="tanh")
    i = cfg.depth
    return h @ params[f"w{i}"] + params[f"b{i}"]


def _grad(loss_fn, params: dict) -> dict:
    with torch.enable_grad():
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(live)
        grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def train_classifier(cfg: ClassifierConfig, xs, ys, *, steps=400,
                     batch=256, lr=2e-3, seed=0,
                     params: Optional[dict] = None, device=None):
    """Plain supervised training; returns (params, final train acc).
    ``params``: the initial parameters (drawn from ``seed`` when None)."""
    device = resolve_device(device)
    if params is None:
        params = init_classifier(
            cfg, torch.Generator(device).manual_seed(seed), device)
    ocfg = OptimizerConfig(learning_rate=lr, warmup_steps=20,
                           total_steps=steps, weight_decay=0.01)
    opt = init_opt_state(params)
    xs = torch.as_tensor(np.asarray(xs), device=device)
    ys = torch.as_tensor(np.asarray(ys), device=device).long()

    def step(params, opt, bx, by):
        def loss_fn(p):
            logp = torch.log_softmax(classifier_apply(cfg, p, bx), -1)
            return -torch.mean(torch.gather(logp, -1, by[:, None]))

        _, grads = _grad(loss_fn, params)
        params, opt, _ = adamw_update(ocfg, params, grads, opt)
        return params, opt

    rng = np.random.RandomState(seed)
    n = xs.shape[0]
    for _ in range(steps):
        idx = torch.as_tensor(rng.randint(0, n, size=batch), device=device)
        params, opt = step(params, opt, xs[idx], ys[idx])

    return params, accuracy(cfg, params, xs, ys)


@torch.no_grad()
def accuracy(cfg: ClassifierConfig, params, xs, ys) -> float:
    device = next(iter(params.values())).device
    xs = torch.as_tensor(np.asarray(xs), device=device)
    ys = torch.as_tensor(np.asarray(ys), device=device)
    pred = torch.argmax(classifier_apply(cfg, params, xs), -1)
    return float(torch.mean((pred == ys).to(torch.float32)))


def train_parity_model(cfg: ClassifierConfig, base_params, xs, k: int, *,
                       steps=600, batch=64, lr=2e-3, seed=1,
                       parity: Optional[dict] = None, device=None):
    """ParM distillation: f_P(sum of K queries) ~ sum of K predictions.
    Returns (parity params, last minibatch loss).  ``parity``: the initial
    parameters (drawn from ``seed + 100`` when None, as the reference
    draws its key).

    K-specific, retrained per base model — the scaling limitation the
    paper removes (its encoder/decoder are model-independent).
    """
    device = resolve_device(device)
    if parity is None:
        parity = init_classifier(
            cfg, torch.Generator(device).manual_seed(seed + 100), device)
    ocfg = OptimizerConfig(learning_rate=lr, warmup_steps=20,
                           total_steps=steps, weight_decay=0.01)
    opt = init_opt_state(parity)
    xs = torch.as_tensor(np.asarray(xs), device=device)

    def step(parity, opt, groups):
        # groups: (B, K, dim)
        with torch.no_grad():
            target = classifier_apply(
                cfg, base_params, groups.reshape(-1, groups.shape[-1])
            ).reshape(groups.shape[0], k, -1).sum(1)

        def loss_fn(p):
            pred = classifier_apply(cfg, p, groups.sum(1))
            return torch.mean((pred - target) ** 2)

        loss, grads = _grad(loss_fn, parity)
        parity, opt, _ = adamw_update(ocfg, parity, grads, opt)
        return parity, opt, loss

    rng = np.random.RandomState(seed)
    n = xs.shape[0]
    loss = None
    for _ in range(steps):
        idx = torch.as_tensor(rng.randint(0, n, size=(batch, k)),
                              device=device)
        parity, opt, loss = step(parity, opt, xs[idx])
    return parity, float(loss)
